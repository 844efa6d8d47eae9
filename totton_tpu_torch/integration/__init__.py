"""OPRA headphone EQ database integration.

Parity with the reference's scripts/integration/ package (opra.py,
opra_cache.py, opra_downloader.py): JSONL database reader with search and
OPRA->APO conversion, versioned local cache with atomic install/rollback,
and a network downloader with an injectable fetcher for offline tests.

OPRA source: https://github.com/opra-project/OPRA (CC BY-SA 4.0).
"""

from totton_tpu_torch.integration.opra import (
    OpraDatabase,
    convert_opra_to_apo,
    apply_modern_target_correction,
    get_database,
)
from totton_tpu_torch.integration.modern_target import MODERN_TARGET_SPEC

__all__ = [
    "OpraDatabase",
    "convert_opra_to_apo",
    "apply_modern_target_correction",
    "get_database",
    "MODERN_TARGET_SPEC",
]
