"""``control.py`` for the ``lm`` cells, with the model's planted faults
(``faults_lm.py``) registered beside the generic ones:

    python3 -m ehfl_bench.control_lm --workload deepseek-v2-lite-5l-ep8.n8.vaoi --seeds 1,2,3 \\
        --modes program,control,renormalised_gates,capacity_drop,no_yarn_mscale,no_kv_norm

takes the same arguments and prints the same lines.  Not part of a
benchmark run."""
from __future__ import annotations

import sys

from ehfl_bench import control, faults_lm


def main(argv=None) -> int:
    faults_lm.register()
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
