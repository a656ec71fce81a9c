"""Shared engine-level value types (both exact/CPU and device backends)."""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..core.events import Event
from ..core.regions import MutationInfo, MutationScore


@dataclass
class AlignParams:
    """Resolved alignment parameters.

    Defaults are the *native-core* defaults (cpp/AlignUtil.h:57-66), which
    apply whenever a key is missing from the user's params dict — including
    the scoring_width=150-vs-conf-100 quirk (_poreseqcpp.pyx:144-151)."""

    lik_offset: float = 4.5
    scoring_width: int = 150
    realign_width: int = 300
    verbose: int = 0

    @classmethod
    def from_dict(cls, params: dict) -> "AlignParams":
        p = cls()
        if "verbose" in params:
            p.verbose = int(params["verbose"])
        if "lik_offset" in params:
            p.lik_offset = float(params["lik_offset"])
        if "realign_width" in params:
            p.realign_width = int(params["realign_width"])
        if "scoring_width" in params:
            p.scoring_width = int(params["scoring_width"])
        return p


@dataclass
class AlignData:
    """Engine-side working set: the analog of the reference's AlignData
    (cpp/AlignData.h:26-35).  Events here are *copies* of the session's events
    (the reference crosses a copying FFI boundary, pyx:99-137); drivers sync
    them back explicitly where the reference calls UpdatePythonEvents."""

    sequence: str
    events: list[Event]
    params: AlignParams
    seqlikes: dict = field(default_factory=dict)

    @classmethod
    def from_session(cls, session) -> "AlignData":
        return cls(
            sequence=session.sequence,
            events=[ev.light_copy() for ev in session.events],
            params=AlignParams.from_dict(session.params),
        )

    def sync_back(self, session) -> None:
        """Mirror UpdatePythonEvents (pyx:131-137) + sequence copy-out."""
        session.sequence = self.sequence
        for sev, dev in zip(session.events, self.events):
            sev.ref_align[:] = dev.ref_align
            sev.ref_like[:] = dev.ref_like


def make_mutscores(muts: list[MutationInfo]) -> list[MutationScore]:
    """MutScore copies with the reference's -1e-6 null-suppression init
    (cpp/AlignUtil.h:80-91)."""
    return [MutationScore(m.start, m.orig, m.mut, -1e-6) for m in muts]
