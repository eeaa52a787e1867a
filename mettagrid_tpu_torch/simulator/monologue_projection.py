"""Monologue-transcript delta projection
(reference: simulator/monologue_projection.py).

Policies can stream a running "monologue" transcript tail in their info
payloads; consumers only want the newly-appended text. The update is the
suffix of the current tail not covered by the previous one, computed with a
KMP suffix/prefix overlap so partial window shifts don't re-emit old text.
"""

from __future__ import annotations

from typing import Any, Optional

MONOLOGUE_TAIL_KEY = "__monologue_transcript_tail"


def _suffix_prefix_overlap(previous_tail: str, current_tail: str) -> int:
    """Length of the longest prefix of current_tail that is a suffix of
    previous_tail (KMP failure function over current, streamed over previous)."""
    if not previous_tail or not current_tail:
        return 0
    pattern = current_tail
    prefix = [0] * len(pattern)
    for i in range(1, len(pattern)):
        match = prefix[i - 1]
        while match > 0 and pattern[i] != pattern[match]:
            match = prefix[match - 1]
        if pattern[i] == pattern[match]:
            match += 1
        prefix[i] = match

    match = 0
    for char in previous_tail[-len(pattern) :]:
        while match > 0 and (match == len(pattern) or char != pattern[match]):
            match = prefix[match - 1]
        if char == pattern[match]:
            match += 1
    return match


def compute_monologue_transcript_update(previous_tail: str, current_tail: str) -> tuple[str, bool]:
    """Return (new_text, reset). reset=True means the transcript restarted
    (no overlap with the previous tail)."""
    if not current_tail or current_tail == previous_tail:
        return "", False
    if not previous_tail:
        return current_tail, False
    if current_tail.startswith(previous_tail):
        return current_tail[len(previous_tail) :], False
    overlap = _suffix_prefix_overlap(previous_tail, current_tail)
    if overlap > 0:
        return current_tail[overlap:], False
    return current_tail, True


def strip_monologue_transcript_tail(
    policy_infos: Optional[dict[str, Any]],
) -> Optional[dict[str, Any]]:
    """Remove the internal tail key before exposing infos to consumers."""
    if not policy_infos:
        return None
    if MONOLOGUE_TAIL_KEY not in policy_infos:
        return policy_infos
    sanitized = {k: v for k, v in policy_infos.items() if k != MONOLOGUE_TAIL_KEY}
    return sanitized or None
