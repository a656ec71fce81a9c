"""poreseq_tpu — JAX nanopore signal-consensus engine.

A from-scratch JAX/XLA framework with the capabilities of the reference
PoreSeq pipeline (see SURVEY.md): event-level pair-HMM alignment, iterative
propose-score-accept consensus error correction, likelihood-based variant
scoring, 1024-state Viterbi candidate generation, and region-sharded
multi-device scaling — plus a bit-faithful CPU "exact" backend used as the
correctness oracle.
"""

from .api import PSAlign, swalign, seqtostates
from .core.params import load_params as LoadParams, save_params as SaveParams
from .core.regions import RegionInfo, MutationInfo, MutationScore
from .io.load import load_aligned_events as LoadAlignedEvents
from .pipeline import mutate as Mutate, variant as Variant
from .cli import main

__all__ = [
    "PSAlign",
    "swalign",
    "seqtostates",
    "LoadParams",
    "SaveParams",
    "RegionInfo",
    "MutationInfo",
    "MutationScore",
    "LoadAlignedEvents",
    "Mutate",
    "Variant",
    "main",
]

__version__ = "0.1.0"
