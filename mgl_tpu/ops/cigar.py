"""Host-side CIGAR decode from the device-produced backtrack.

Replays the reference's run-length backtrack walk and overhang
post-processing (sw.cpp:149-255) against the diag-major backtrack emitted by
ops/sw.py: cell (i, j) of pair b lives at btr[i + j - 2, b, i] (the forward
pass emits diagonals d = 2 .. T+Q).

The walk jumps over gap runs (run-length codes) and steps one cell per
matched base, so a Python loop per pair stays cheap at read lengths.
"""

from __future__ import annotations

import numpy as np

from mgl_tpu.core.params import (
    OverhangStrategy,
    STATE_CLIP,
    STATE_DEL,
    STATE_INS,
    STATE_MATCH,
)


def decode_one(
    btr: np.ndarray,        # (D, R) int16 diag-major backtrack for one pair
    ez: dict,               # scalar ScoreMax entries for this pair
    tlen: int,
    qlen: int,
    strategy: OverhangStrategy,
) -> tuple[str, int]:
    segment_length = 0
    if strategy == OverhangStrategy.INDEL:
        I, J = tlen, qlen
    elif strategy != OverhangStrategy.LEADING_INDEL:
        I, J = int(ez["max_t"]), int(ez["max_q"])
        segment_length = int(ez["seg_length"])
    else:
        I, J = int(ez["mqe_t"]), qlen

    result = []
    if segment_length > 0 and strategy == OverhangStrategy.SOFTCLIP:
        result.append((STATE_CLIP, segment_length))
        segment_length = 0

    state = STATE_MATCH
    while True:
        b = int(btr[I + J - 2, I])
        if b > 0:
            next_state, step_length = STATE_DEL, b
        elif b < 0:
            next_state, step_length = STATE_INS, -b
        else:
            next_state, step_length = STATE_MATCH, 1

        if next_state == STATE_MATCH:
            I -= 1
            J -= 1
        elif next_state == STATE_INS:
            J -= step_length
        else:
            I -= step_length

        if next_state == state:
            segment_length += step_length
        else:
            result.append((state, segment_length))
            segment_length = step_length
            state = next_state

        if not (I > 0 and J > 0):
            break

    if strategy == OverhangStrategy.SOFTCLIP:
        result.append((state, segment_length))
        if J > 0:
            result.append((STATE_CLIP, J))
        offset = I
    elif strategy == OverhangStrategy.IGNORE:
        result.append((state, segment_length + J))
        offset = I - J
    else:
        result.append((state, segment_length))
        if I > 0:
            result.append((STATE_DEL, I))
        elif J > 0:
            result.append((STATE_INS, J))
        offset = 0

    cigar = "".join(f"{n}{s}" for s, n in reversed(result) if n > 0)
    return cigar, offset


def decode_batch(
    btr: np.ndarray,        # (D, B, R) int16
    ez: dict,               # dict of (B,) arrays from compute_score_max
    tlen: np.ndarray,
    qlen: np.ndarray,
    strategy: OverhangStrategy,
) -> list[tuple[str, int]]:
    out = []
    for b in range(len(tlen)):
        ez_b = {k: v[b] for k, v in ez.items()}
        out.append(
            decode_one(btr[:, b, :], ez_b, int(tlen[b]), int(qlen[b]), strategy)
        )
    return out
