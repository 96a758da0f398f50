"""The port's registered ops, in one import.

Importing this module registers every `srfdet::` op that an exported
program may call: `srfdet::gather_conv` (K1, float32 and bfloat16),
`srfdet::eqmatch_rulebook` and `srfdet::plan_map` (K2),
`srfdet::key_hash` and `srfdet::rulebook_lookup` (K6).  A process that
loads a `.pt2` artifact of `tools/export.py` imports it before
`torch.export.load`; it imports nothing of `srfdet3d_torch.models`.
"""

from . import eqmatch, gather_conv, rulebook_lookup  # noqa: F401
