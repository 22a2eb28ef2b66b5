"""One module a model family: its inputs, the port's backend, the reference
model and the counts of its work."""
