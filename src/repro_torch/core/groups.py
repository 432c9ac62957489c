"""Object-count group rules (paper §3: groups '0','1','2','3','4 or more')."""
from __future__ import annotations

from typing import List, Sequence, Tuple

# (lo, hi_inclusive, label); hi = None means unbounded
DEFAULT_GROUP_RULES: Tuple[Tuple[int, int, int], ...] = (
    (0, 0, 0),
    (1, 1, 1),
    (2, 2, 2),
    (3, 3, 3),
    (4, None, 4),
)

GROUP_LABELS = {0: "0", 1: "1", 2: "2", 3: "3", 4: "4+"}


def group_of(count: int, rules: Sequence[Tuple[int, int, int]] = DEFAULT_GROUP_RULES) -> int:
    """Algorithm 1 lines 1-7: find the group whose range contains count."""
    for lo, hi, label in rules:
        if count >= lo and (hi is None or count <= hi):
            return label
    return rules[-1][2]


def all_groups(rules: Sequence[Tuple[int, int, int]] = DEFAULT_GROUP_RULES) -> List[int]:
    return [label for _, _, label in rules]
