"""Shape layers and the TimeDistributed wrapper (the port of
``nn/shape_ops.py``): Reshape, Permute, RepeatVector, Flatten and
TimeDistributed, parameter-free except for the layer TimeDistributed
wraps.  Their config fields and JSON are the JAX package's; each is a
reshape, transpose or repeat of the tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.core import InputType, Layer


def input_type_from_shape(shape: Sequence[int]) -> InputType:
    """Batch-less shape tuple -> InputType (rank 1 = feed-forward, 2 =
    recurrent [T, F], 3 = NHWC, 4 = NDHWC)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 1:
        return InputType.feed_forward(shape[0])
    if len(shape) == 2:
        return InputType.recurrent(shape[1], shape[0])
    if len(shape) == 3:
        return InputType.convolutional(*shape)
    if len(shape) == 4:
        return InputType.convolutional3d(*shape)
    raise ValueError(f"Unsupported target rank {len(shape)}")


@dataclasses.dataclass(kw_only=True)
class ReshapeLayer(Layer):
    """Reshape the non-batch dims to `target_shape`."""

    target_shape: Tuple[int, ...] = ()
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        out = input_type_from_shape(self.target_shape)
        if input_type.flat_size() != out.flat_size():
            raise ValueError(
                f"Reshape: {input_type.shape} has {input_type.flat_size()} "
                f"elements, target {tuple(self.target_shape)} has "
                f"{out.flat_size()}")
        return {}, {}, out

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.target_shape)), state


@dataclasses.dataclass(kw_only=True)
class PermuteLayer(Layer):
    """Transpose the non-batch dims by `dims` (1-indexed, batch excluded,
    as Keras's ``Permute``)."""

    dims: Tuple[int, ...] = ()
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        if sorted(self.dims) != list(range(1, len(input_type.shape) + 1)):
            raise ValueError(f"Permute dims {self.dims} must be a "
                             f"permutation of 1..{len(input_type.shape)}")
        out_shape = tuple(input_type.shape[d - 1] for d in self.dims)
        return {}, {}, input_type_from_shape(out_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.permute((0,) + tuple(self.dims)), state


@dataclasses.dataclass(kw_only=True)
class RepeatVectorLayer(Layer):
    """[B, F] -> [B, n, F]: a feed-forward activation repeated into a
    sequence."""

    n: int = 0
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        if input_type.kind != "feedforward":
            raise ValueError("RepeatVector requires feed-forward input, "
                             f"got {input_type.kind}")
        return {}, {}, InputType.recurrent(input_type.shape[0], self.n)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x[:, None, :].repeat(1, self.n, 1), state


@dataclasses.dataclass(kw_only=True)
class TimeDistributed(Layer):
    """Applies a feed-forward `underlying` layer at every timestep of a
    [B, T, ...] input: time folds into the batch, the layer runs once (a
    relu Dense reaches ``fused_dense`` with M = B*T), and the result
    unfolds.  The wrapper's parameters and state are the underlying
    layer's, under the same keys and layouts; its JSON nests the
    underlying layer's."""

    underlying: Optional[Layer] = None
    STOCHASTIC = True
    REGULARIZABLE = ()

    def __post_init__(self):
        if self.underlying is None:
            raise ValueError("TimeDistributed requires underlying=...")

    @property
    def TORCH_LAYOUT(self):
        return self.underlying.TORCH_LAYOUT

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        if input_type.kind != "recurrent":
            raise ValueError("TimeDistributed requires recurrent input "
                             f"[T, F], got {input_type.kind}")
        T, F = input_type.shape
        if self.underlying.weight_init is None:
            self.underlying.weight_init = self.weight_init
        p, s, ot = self.underlying.initialize(
            gen, InputType.feed_forward(F), dtype, device)
        if ot.kind != "feedforward":
            raise ValueError("TimeDistributed inner layer must map "
                             "feed-forward -> feed-forward")
        return p, s, InputType.recurrent(ot.shape[0], T)

    def regularizable_mask(self, params):
        return self.underlying.regularizable_mask(params)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        B, T = x.shape[0], x.shape[1]
        flat = x.reshape((B * T,) + tuple(x.shape[2:]))
        y, s = self.underlying.apply(params, state, flat, train=train,
                                     rng=rng, mask=None)
        return y.reshape((B, T) + tuple(y.shape[1:])), s


@dataclasses.dataclass(kw_only=True)
class FlattenLayer(Layer):
    """Flatten all non-batch dims to a feed-forward vector."""

    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, InputType.feed_forward(input_type.flat_size())

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape(x.shape[0], -1), state
