"""lm.moe.rows_per_token (count): the expert-MLP rows the port's expert
layers computed over the tokens that entered them, from the program's
host counter ``repro_torch.models.moe.COUNTS`` (summed from shapes since
the run began; the shapes are fixed, so every epoch gives the same
ratio).  A dropless share that runs every token through each held expert
reads the experts held; the routed choices need top-k x held / routed of
them.  Nothing where the program has no such counter or counted nothing."""
import sys


def read(tr):
    counts = getattr(sys.modules.get("repro_torch.models.moe"), "COUNTS", None)
    if not counts or not counts.get("tokens") or not counts.get("rows"):
        return None
    return counts["rows"] / counts["tokens"]
