"""The graded failure model of the library API.

Counterpart of `classify` in `parmmg_tpu/failsafe.py`; the rest of that
module (validation levels, checkpoint and resume, fault plans) is ROADMAP
queue 1, item 15.
"""

from __future__ import annotations

from .core import tags


def classify(exc: BaseException, have_mesh: bool) -> tags.ReturnStatus:
    """Map an exception escaping a driver onto the graded status ladder:
    LOWFAILURE iff a conformal result mesh survives, STRONGFAILURE
    otherwise."""
    if have_mesh:
        return tags.ReturnStatus.LOWFAILURE
    return tags.ReturnStatus.STRONGFAILURE
