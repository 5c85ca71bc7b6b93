"""Frames, tags, and deadness — the paper's Fig. 5 value model.

Every value flowing through the dynamic-dataflow reference executor is a
``TaggedValue(value, is_dead, tag)`` triple, exactly as in §4.3 of the
paper: ``value`` is the payload tensor, ``is_dead`` marks values on the
untaken branch of a Switch, and ``tag`` names the dynamic execution
context (frame) the value belongs to.

Tags are paths: the root frame has tag ``()``; ``Enter`` into frame
``name`` appends ``(name, 0)``; ``NextIteration`` bumps the trailing
iteration counter; ``Exit`` pops back to the parent. This is the
``tag1/name/n`` scheme of Fig. 5 in structured form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

# A tag is a tuple of (frame_name, iteration) pairs; () is the root frame.
Tag = Tuple[Tuple[str, int], ...]

ROOT_TAG: Tag = ()


def enter_tag(tag: Tag, name: str) -> Tag:
    """Tag of iteration 0 of child frame `name` (Fig. 5: tag/name/0)."""
    return tag + ((name, 0),)


def next_iteration_tag(tag: Tag) -> Tag:
    """Bump the innermost iteration counter (Fig. 5: tag1/name/(n+1))."""
    if not tag:
        raise ValueError("NextIteration in the root frame is illegal")
    (name, n) = tag[-1]
    return tag[:-1] + ((name, n + 1),)


def exit_tag(tag: Tag) -> Tag:
    """Tag of the parent frame (Fig. 5: c.parent.tag)."""
    if not tag:
        raise ValueError("Exit from the root frame is illegal")
    return tag[:-1]


def tag_depth(tag: Tag) -> int:
    return len(tag)


def format_tag(tag: Tag) -> str:
    """Human-readable form matching the paper's `tag1/name/n` notation."""
    if not tag:
        return "/"
    return "/" + "/".join(f"{name}/{n}" for name, n in tag)


@dataclasses.dataclass(frozen=True)
class TaggedValue:
    """(value, is_dead, tag) triple of §4.3.

    ``value`` may be any array-like payload. Dead values keep their
    payload (the paper propagates a dead *signal*; we keep the tensor so
    shapes remain known — semantically it must never be observed).
    """

    value: Any
    is_dead: bool = False
    tag: Tag = ROOT_TAG

    def with_value(self, value: Any) -> "TaggedValue":
        return TaggedValue(value, self.is_dead, self.tag)

    def dead(self) -> "TaggedValue":
        return TaggedValue(self.value, True, self.tag)


def live(value: Any, tag: Tag = ROOT_TAG) -> TaggedValue:
    return TaggedValue(torch.as_tensor(value), False, tag)


def same_frame(*vals: TaggedValue) -> bool:
    """All inputs to a non-Merge op must carry the same tag (Fig. 5)."""
    tags = {v.tag for v in vals}
    return len(tags) <= 1
