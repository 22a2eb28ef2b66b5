"""PyTorch/CUDA port of the EHFL simulator (``repro``), module for module.

Mirrors ``src/repro/``'s layout and names; imports ``torch`` and numpy only.
Entry points run on the GPU unless the caller passes ``device="cpu"``."""
