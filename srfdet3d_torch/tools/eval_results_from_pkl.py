"""Re-run evaluation from a dumped results pickle (the JAX package's
`tools/eval_results_from_pkl.py`, the reference's CLI surface).

Usage:
  python -m srfdet3d_torch.tools.eval_results_from_pkl <config_name>
      <results.pkl> [test.py arguments]

A thin alias over `python -m srfdet3d_torch.tools.test <config_name>
--eval-from-pkl <results.pkl>`; the dump comes from the test CLI's
`--out results.pkl`.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    """Evaluate the dump; returns the test CLI's metric dict."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        raise SystemExit(__doc__)
    from . import test
    config, pkl, rest = argv[0], argv[1], argv[2:]
    return test.main([config, "--eval-from-pkl", pkl] + rest)


if __name__ == "__main__":
    main()
