"""Mining (port of sskd_tpu/mining): the BM25 index and the three-stage
negative curriculum."""

from sskd_tpu_torch.mining.bm25 import BM25Index, build_bm25_index
from sskd_tpu_torch.mining.miners import (
    ANCEMiner,
    BM25Miner,
    MinedNegatives,
    TeacherMiner,
    build_mining_curriculum,
    refresh_ance_negatives,
)

__all__ = [
    "BM25Index",
    "build_bm25_index",
    "BM25Miner",
    "TeacherMiner",
    "ANCEMiner",
    "MinedNegatives",
    "build_mining_curriculum",
    "refresh_ance_negatives",
]
