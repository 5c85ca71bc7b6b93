"""The paper's primary contribution in the port: dynamic control flow
with automatic differentiation (``while_loop`` with stack-saving AD and
its §5.3 save policies, ``cond``, the differentiable ``TensorArray``,
the higher-order functions built on the loop) and the Fig. 5 primitives
with their eager dataflow oracle. Same names and ``__all__`` as the JAX
package's ``repro.core``."""

from .cond import cond
from .dataflow_ref import dataflow_cond, dataflow_while
from .frames import ROOT_TAG, Tag, TaggedValue, format_tag
from .higher_order import foldl, foldr, map_fn, scan
from .primitives import (apply_op, enter, exit_, merge, next_iteration,
                         switch)
from .tensor_array import TensorArray, WriteOnceError
from .while_loop import fori_loop, while_loop

__all__ = [
    "ROOT_TAG", "Tag", "TaggedValue", "format_tag",
    "switch", "merge", "enter", "exit_", "next_iteration", "apply_op",
    "TensorArray", "WriteOnceError",
    "while_loop", "fori_loop",
    "cond", "dataflow_cond", "dataflow_while",
    "scan", "map_fn", "foldl", "foldr",
]
