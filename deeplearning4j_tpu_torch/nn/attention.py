"""Attention layers and scaled dot-product attention (the port of
``nn/attention.py``): SelfAttentionLayer, LearnedSelfAttentionLayer and
RecurrentAttentionLayer over ``[B, T, F]``, heads split internally to
``[B, heads, T, dh]``.

:func:`multi_head_attention` without dropout goes through the port's
``ops.attention_kernels.fused_attention``: on the card that launches the
flash forward kernel, and its backward the dQ and dK/dV kernels
(``ops/kernels/attention.py``); on the CPU it runs the JAX package's plain
path.  The kernel takes a float ``[B, S]`` keep-mask, so a bool or int
mask is cast to q's dtype here.  With dropout, and inside
RecurrentAttentionLayer's loop, attention is the plain
:func:`dot_product_attention`, as in the JAX package.  A head larger than
the kernel's 128 makes ``fused_attention`` raise on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.core import InputType, Layer
from deeplearning4j_tpu_torch.nn.recurrent import _scan
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def dot_product_attention(q, k, v, mask=None, scaled: bool = True,
                          dropout_rate: float = 0.0,
                          rng: Optional[torch.Generator] = None):
    """Scaled dot-product attention (the ``dotProductAttention`` op).

    q: [..., Tq, dh], k/v: [..., Tk, dh]; mask: broadcastable to [..., Tq,
    Tk] (nonzero = keep).  A masked score is the dtype's lowest finite
    value, so a row with every key masked gets uniform weights.  Returns
    [..., Tq, dh]."""
    dh = q.shape[-1]
    scores = torch.einsum("...qd,...kd->...qk", q, k)
    if scaled:
        scores = scores / torch.full((), dh, dtype=scores.dtype, device=scores.device).sqrt()
    if mask is not None:
        big_neg = torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                             device=scores.device)
        scores = torch.where(mask != 0, scores, big_neg)
    w = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and rng is not None:
        keep = torch.rand(w.shape, generator=rng, device=w.device) < 1.0 - dropout_rate
        w = torch.where(keep, w / (1.0 - dropout_rate), torch.zeros_like(w))
    return torch.einsum("...qk,...kd->...qd", w, v)


def multi_head_attention(x_q, x_kv, params, n_heads, mask=None, rng=None,
                         dropout_rate: float = 0.0):
    """Multi-head attention with packed projections
    (``multiHeadDotProductAttention``): params holds Wq, Wk, Wv ``[F,
    H*dh]`` and Wo ``[H*dv, F_out]``; `mask` is a [B, Tk] keep-mask."""
    from deeplearning4j_tpu_torch.ops.attention_kernels import fused_attention

    B, Tq = x_q.shape[0], x_q.shape[1]

    def split(y):
        return y.reshape(B, y.shape[1], n_heads, y.shape[-1] // n_heads).permute(0, 2, 1, 3)

    q = split(x_q @ params["Wq"])
    k = split(x_kv @ params["Wk"])
    v = split(x_kv @ params["Wv"])
    if dropout_rate > 0.0 and rng is not None:
        # weight dropout needs the materialized probabilities: the plain path
        o = dot_product_attention(q, k, v,
                                  mask=None if mask is None else mask[:, None, None, :],
                                  dropout_rate=dropout_rate, rng=rng)
    else:
        o = fused_attention(q, k, v, mask=None if mask is None else mask.to(q.dtype))
    return o.permute(0, 2, 1, 3).reshape(B, Tq, -1) @ params["Wo"]


@dataclasses.dataclass(kw_only=True)
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over a sequence: queries = keys = values
    = the input; with `project_input` through learned Q/K/V/O
    projections."""

    n_out: int = 0          # output size (projected); 0 = n_in
    n_heads: int = 1
    head_size: int = 0      # 0 = n_out / n_heads
    project_input: bool = True
    REGULARIZABLE = ("Wq", "Wk", "Wv", "Wo")
    STOCHASTIC = True

    def _sizes(self, n_in):
        n_out = self.n_out or n_in
        return n_out, self.head_size or (n_out // self.n_heads)

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = int(input_type.shape[-1])
        n_out, dh = self._sizes(n_in)
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError("project_input=False requires n_heads=1")
            return {}, {}, InputType.recurrent(n_in, input_type.shape[0])
        H = self.n_heads
        params = {k: init_weights(gen, shape, self.winit(), dtype, device)
                  for k, shape in (("Wq", (n_in, H * dh)), ("Wk", (n_in, H * dh)),
                                   ("Wv", (n_in, H * dh)), ("Wo", (H * dh, n_out)))}
        return params, {}, InputType.recurrent(n_out, input_type.shape[0])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        if not self.project_input:
            m = None if mask is None else mask[:, None, :]
            return dot_product_attention(x, x, x, mask=m), state
        y = multi_head_attention(x, x, params, self.n_heads, mask=mask)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state


@dataclasses.dataclass(kw_only=True)
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """Attention with `n_queries` learned query vectors: the output is
    ``[B, n_queries, n_out]`` whatever the input's length (so an MLN drops
    the sequence mask after it)."""

    n_queries: int = 1
    # the learned queries are a weight matrix, regularized like the projections
    REGULARIZABLE = ("Wq", "Wk", "Wv", "Wo", "Q")

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        if not self.project_input:
            raise ValueError(
                "LearnedSelfAttentionLayer requires project_input=True "
                "(learned queries only exist alongside Q/K/V projections)")
        n_in = int(input_type.shape[-1])
        n_out, _ = self._sizes(n_in)
        params, state, _ = super().initialize(gen, input_type, dtype, device)
        params["Q"] = init_weights(gen, (self.n_queries, n_in), self.winit(), dtype, device)
        return params, state, InputType.recurrent(n_out, self.n_queries)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        q = params["Q"].expand((x.shape[0],) + tuple(params["Q"].shape))
        return multi_head_attention(q, x, params, self.n_heads, mask=mask), state


@dataclasses.dataclass(kw_only=True)
class RecurrentAttentionLayer(Layer):
    """Recurrent cell with attention over the whole input at each step:
    h_t = act(x_t W + h_{t-1} RW + attn(h_{t-1}, x) Wo + b), the attention
    plain (no kernel), as in the JAX package."""

    n_out: int = 0
    n_heads: int = 1
    REGULARIZABLE = ("W", "RW", "Wq", "Wk", "Wv", "Wo")
    STOCHASTIC = True

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = int(input_type.shape[-1])
        H = self.n_out
        W = init_weights(gen, (n_in, H), self.winit(), dtype, device)
        params = {
            "W": W,
            "RW": init_weights(gen, (H, H), self.winit(), dtype, device),
            "b": torch.full((H,), self.bias_init, dtype=dtype, device=W.device),
            "Wq": init_weights(gen, (H, H), self.winit(), dtype, device),
            "Wk": init_weights(gen, (n_in, H), self.winit(), dtype, device),
            "Wv": init_weights(gen, (n_in, H), self.winit(), dtype, device),
            "Wo": init_weights(gen, (H, H), self.winit(), dtype, device),
        }
        return params, {}, InputType.recurrent(H, input_type.shape[0])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        act = self.act_fn("tanh")
        xp = x @ params["W"] + params["b"]
        keys = x @ params["Wk"]
        vals = x @ params["Wv"]
        kmask = None if mask is None else mask[:, None, :]

        def cell(h, xt, _):
            q = (h @ params["Wq"])[:, None, :]
            a = dot_product_attention(q, keys, vals, mask=kmask)[:, 0, :]
            h_new = act(xt + h @ params["RW"] + a @ params["Wo"])
            return h_new, h_new

        h0 = torch.zeros((x.shape[0], self.n_out), dtype=xp.dtype, device=xp.device)
        out = _scan(cell, h0, xp, None)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out, state
