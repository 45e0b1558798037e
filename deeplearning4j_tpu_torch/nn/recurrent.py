"""Recurrent layers (the port of ``nn/recurrent.py``): SimpleRnn, LSTM,
GRU, GravesLSTM, Bidirectional, LastTimeStep, RnnOutputLayer and
RnnLossLayer.

The parameter layout and gate order are the JAX package's, so a JAX tree
crosses without a layout permutation: an LSTM's ``W`` is ``[n_in, 4H]``
and its ``RW`` ``[H, 4H]``, gate blocks in IFOG order (input, forget,
output, gate), the forget block of ``b`` set to
``forget_gate_bias_init``; GravesLSTM adds the ``pW`` peepholes ``(3,
H)``; a GRU's blocks are (r, z, n) with a separate recurrent bias
``rb``.  Activations are ``[B, T, F]``.

The step is the JAX package's: one batched input projection ``x @ W + b``
over all steps, then a Python loop over T for the recurrent half, where
the JAX package runs ``lax.scan``, with the cell arithmetic in the same
order.  A ``[B, T]`` mask holds ``h`` (and ``c``) at a masked step
(``torch.where``) and multiplies the output.  The loop reads no value
back to the host and branches only on what is static (whether there is a
mask), and its zeros are made on the input's device in its dtype, so k
training steps capture into one CUDA graph (``utils/scan_fit.py``).
``torch.nn.LSTM`` and cuDNN's RNN are not used: their gate order, their
lack of masks and peepholes, and their rounding would part from the
reference.  There is no kernel here: the JAX package computes these
products outside any Pallas kernel.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.core import InputType, Layer
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def _mask_bt(mask, x):
    """Broadcast a [B, T] mask against [B, T, ...] `x`."""
    if mask is None:
        return None
    m = mask
    while m.ndim < x.ndim:
        m = m[..., None]
    return m


def _scan(cell, carry, xs, m):
    """``lax.scan`` over time: `cell(carry, x_t, keep_t) -> (carry, h_t)`
    for each step of `xs` [B, T, ...]; `keep_t` is the step's mask as bool
    (None without a mask).  Returns the outputs stacked to [B, T, H]."""
    keep = None if m is None else m != 0
    hs = []
    for t in range(xs.shape[1]):
        carry, h = cell(carry, xs[:, t], None if keep is None else keep[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


def _masked_out(out, m):
    return out if m is None else out * m.to(out.dtype)


def _last_valid(m):
    """Index of each row's last step whose mask is at its maximum (the
    last nonzero step of a 0/1 mask), as the JAX package finds it:
    ``T - 1 - argmax(flip(m))``, the first maximum on ties."""
    if not m.is_floating_point():
        m = m.to(torch.float32)
    return m.shape[1] - 1 - torch.argmax(torch.flip(m, dims=(1,)), dim=1)


def _take_steps(y, idx):
    """y[b, idx[b]] of a [B, T, H] tensor."""
    return torch.gather(y, 1, idx[:, None, None].expand(-1, 1, y.shape[-1]))[:, 0]


# ---------------------------------------------------------------------------
# Base recurrent
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class BaseRecurrentLayer(Layer):
    """Common config of the recurrent layers: n_out units, sequence in and
    sequence out."""

    n_out: int = 0
    STOCHASTIC = True

    def _in_size(self, input_type: InputType) -> int:
        if input_type.kind != "recurrent":
            raise ValueError(
                f"{type(self).__name__} needs recurrent input, got {input_type}")
        return int(input_type.shape[-1])

    def _out_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.shape[0])


@dataclasses.dataclass(kw_only=True)
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: h_t = act(x_t W + h_{t-1} RW + b)."""

    REGULARIZABLE = ("W", "RW")

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self._in_size(input_type)
        W = init_weights(gen, (n_in, self.n_out), self.winit(), dtype, device)
        params = {
            "W": W,
            "RW": init_weights(gen, (self.n_out, self.n_out), self.winit(), dtype, device),
            "b": torch.full((self.n_out,), self.bias_init, dtype=dtype, device=W.device),
        }
        return params, {}, self._out_type(input_type)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        act = self.act_fn("tanh")
        RW = params["RW"]
        xp = x @ params["W"] + params["b"]
        m = _mask_bt(mask, xp)

        def cell(h, xt, keep):
            h_new = act(xt + h @ RW)
            if keep is not None:
                h_new = torch.where(keep, h_new, h)
            return h_new, h_new

        h0 = torch.zeros((x.shape[0], self.n_out), dtype=xp.dtype, device=xp.device)
        return _masked_out(_scan(cell, h0, xp, m), m), state


@dataclasses.dataclass(kw_only=True)
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes: IFOG gate blocks, forget bias 1.0."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Any = "sigmoid"
    #: a field, as in the JAX package, so it reaches the JSON
    PEEPHOLE: bool = False
    REGULARIZABLE = ("W", "RW")

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in, H = self._in_size(input_type), self.n_out
        W = init_weights(gen, (n_in, 4 * H), self.winit(), dtype, device)
        b = torch.full((4 * H,), self.bias_init, dtype=dtype, device=W.device)
        b[H:2 * H] = self.forget_gate_bias_init        # the forget block (IFOG)
        params = {
            "W": W,
            "RW": init_weights(gen, (H, 4 * H), self.winit(), dtype, device),
            "b": b,
        }
        if self.PEEPHOLE:
            # Graves-style peepholes: one vector per i/f/o gate
            params["pW"] = init_weights(gen, (3, H), "UNIFORM", dtype, device)
        return params, {}, self._out_type(input_type)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        H = self.n_out
        act = self.act_fn("tanh")
        gate = get_activation(self.gate_activation)
        RW = params["RW"]
        xp = x @ params["W"] + params["b"]
        m = _mask_bt(mask, x[..., :1])
        peep = params.get("pW")

        def cell(carry, xt, keep):
            h, c = carry
            z = xt + h @ RW
            zi, zf, zo, zg = torch.split(z, H, dim=-1)
            if peep is not None:
                zi = zi + c * peep[0]
                zf = zf + c * peep[1]
            i, f, g = gate(zi), gate(zf), act(zg)
            c_new = f * c + i * g
            if peep is not None:
                zo = zo + c_new * peep[2]
            o = gate(zo)
            h_new = o * act(c_new)
            if keep is not None:
                h_new = torch.where(keep, h_new, h)
                c_new = torch.where(keep, c_new, c)
            return (h_new, c_new), h_new

        zeros = torch.zeros((x.shape[0], H), dtype=xp.dtype, device=xp.device)
        return _masked_out(_scan(cell, (zeros, zeros), xp, m), m), state


@dataclasses.dataclass(kw_only=True)
class GRU(BaseRecurrentLayer):
    """GRU in keras' ``reset_after=True`` form (r gates the already-linear
    recurrent term); gate blocks (r, z, n); separate input and recurrent
    biases."""

    gate_activation: Any = "sigmoid"
    REGULARIZABLE = ("W", "RW")

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in, H = self._in_size(input_type), self.n_out
        W = init_weights(gen, (n_in, 3 * H), self.winit(), dtype, device)
        params = {
            "W": W,
            "RW": init_weights(gen, (H, 3 * H), self.winit(), dtype, device),
            "b": torch.full((3 * H,), self.bias_init, dtype=dtype, device=W.device),
            "rb": torch.zeros((3 * H,), dtype=dtype, device=W.device),
        }
        return params, {}, self._out_type(input_type)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        H = self.n_out
        act = self.act_fn("tanh")
        gate = get_activation(self.gate_activation)
        RW, rb = params["RW"], params["rb"]
        xp = x @ params["W"] + params["b"]
        m = _mask_bt(mask, x[..., :1])

        def cell(h, xt, keep):
            gh = h @ RW + rb
            r = gate(xt[..., :H] + gh[..., :H])
            z = gate(xt[..., H:2 * H] + gh[..., H:2 * H])
            n = act(xt[..., 2 * H:] + r * gh[..., 2 * H:])
            h_new = (1 - z) * n + z * h
            if keep is not None:
                h_new = torch.where(keep, h_new, h)
            return h_new, h_new

        h0 = torch.zeros((x.shape[0], H), dtype=xp.dtype, device=xp.device)
        return _masked_out(_scan(cell, h0, xp, m), m), state


@dataclasses.dataclass(kw_only=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013)."""

    PEEPHOLE: bool = True
    # the peephole vectors are weights, regularized with W and RW
    REGULARIZABLE = ("W", "RW", "pW")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class Bidirectional(Layer):
    """Runs an inner recurrent layer forward and backward over time and
    merges the two (ADD, MUL, AVERAGE or CONCAT).  Parameters and state
    nest as ``{"fwd": ..., "bwd": ...}``.

    ``return_last=True`` merges the forward output at the last valid step
    with the backward output after the whole sequence (original position
    0), as a feed-forward activation; a row with no valid step gives
    zeros."""

    fwd: Optional[Layer] = None
    mode: str = "CONCAT"
    return_last: bool = False
    REGULARIZABLE = ()
    STOCHASTIC = True

    def __post_init__(self):
        if self.fwd is None:
            raise ValueError("Bidirectional requires an inner layer (fwd=...)")

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        self._bwd = copy.deepcopy(self.fwd)
        if self.fwd.weight_init is None:
            self.fwd.weight_init = self.weight_init
        if self._bwd.weight_init is None:
            self._bwd.weight_init = self.weight_init
        pf, sf, of = self.fwd.initialize(gen, input_type, dtype, device)
        pb, sb, _ = self._bwd.initialize(gen, input_type, dtype, device)
        n_out = 2 * of.shape[-1] if self.mode == "CONCAT" else of.shape[-1]
        out = (InputType.feed_forward(n_out) if self.return_last
               else InputType.recurrent(n_out, of.shape[0]))
        return {"fwd": pf, "bwd": pb}, {"fwd": sf, "bwd": sb}, out

    def regularizable_mask(self, params):
        inner = self.fwd.regularizable_mask
        return {"fwd": inner(params["fwd"]), "bwd": inner(params["bwd"])}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        yf, sf = self.fwd.apply(params["fwd"], state["fwd"], x, train=train,
                                rng=rng, mask=mask)
        # reverse time, run, reverse back; the mask flips with it
        mr = None if mask is None else torch.flip(mask, dims=(1,))
        yb, sb = self._bwd.apply(params["bwd"], state["bwd"], torch.flip(x, dims=(1,)),
                                 train=train, rng=rng, mask=mr)
        yb = torch.flip(yb, dims=(1,))
        if self.return_last:
            if mask is None:
                yf, yb = yf[:, -1], yb[:, 0]
            else:
                yf, yb = _take_steps(yf, _last_valid(mask)), yb[:, 0]
                valid = torch.any(mask > 0, dim=1)[:, None]
                zero = torch.zeros((), dtype=yf.dtype, device=yf.device)
                yf = torch.where(valid, yf, zero)
                yb = torch.where(valid, yb, zero)
        if self.mode == "CONCAT":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "ADD":
            y = yf + yb
        elif self.mode == "MUL":
            y = yf * yb
        elif self.mode == "AVERAGE":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(f"Unknown Bidirectional mode {self.mode}")
        return y, {"fwd": sf, "bwd": sb}


@dataclasses.dataclass(kw_only=True)
class LastTimeStep(Layer):
    """Wraps a recurrent layer and returns its last (valid) step as a
    feed-forward activation: with a mask, each row's last nonzero step,
    contiguous or not."""

    underlying: Optional[Layer] = None
    REGULARIZABLE = ()
    STOCHASTIC = True

    def __post_init__(self):
        if self.underlying is None:
            raise ValueError("LastTimeStep requires underlying=...")

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        if self.underlying.weight_init is None:
            self.underlying.weight_init = self.weight_init
        p, s, ot = self.underlying.initialize(gen, input_type, dtype, device)
        return p, s, InputType.feed_forward(ot.shape[-1])

    def regularizable_mask(self, params):
        return self.underlying.regularizable_mask(params)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        y, s = self.underlying.apply(params, state, x, train=train, rng=rng, mask=mask)
        if mask is None:
            return y[:, -1, :], s
        return _take_steps(y, _last_valid(mask)), s


# ---------------------------------------------------------------------------
# Recurrent output heads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class RnnOutputLayer(Layer):
    """Time-distributed dense + per-step loss: labels [B, T, C]; a [B, T]
    labels mask leaves padded steps out of the loss mean."""

    n_out: int = 0
    loss: Any = "mcxent"
    has_bias: bool = True
    STOCHASTIC = True

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = input_type.shape[-1]
        W = init_weights(gen, (n_in, self.n_out), self.winit(), dtype, device)
        params = {"W": W}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                     device=W.device)
        return params, {}, InputType.recurrent(self.n_out, input_type.shape[0])

    def _pre(self, params, x):
        y = x @ params["W"]
        return y + params["b"] if self.has_bias else y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        return self.act_fn("softmax")(self._pre(params, x)), state

    def compute_loss(self, params, state, x, labels, *, train=True, rng=None,
                     mask=None):
        from deeplearning4j_tpu_torch.ops.losses import apply_loss
        x = self.maybe_input_dropout(x, train, rng)
        return apply_loss(self.loss, self.act_fn("softmax"), self._pre(params, x),
                          labels, mask)


@dataclasses.dataclass(kw_only=True)
class RnnLossLayer(Layer):
    """Parameter-free per-step loss head."""

    loss: Any = "mcxent"
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.act_fn()(x), state

    def compute_loss(self, params, state, x, labels, *, train=True, rng=None,
                     mask=None):
        from deeplearning4j_tpu_torch.ops.losses import apply_loss
        return apply_loss(self.loss, self.act_fn(), x, labels, mask)
