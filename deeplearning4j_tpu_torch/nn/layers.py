"""Feed-forward and convolutional layers (the port of ``nn/layers.py``).

Ported: Dense, Output, Loss, Activation, Dropout, Convolution,
Subsampling, GlobalPooling, BatchNormalization and LayerNormalization, with
the JAX package's config fields and semantics:

* activations are NHWC at every layer boundary.  Convolution and pooling
  run on an NCHW view of the NHWC tensor (``permute``; a channels-last
  view, no copy), so a flatten before a Dense layer sees NHWC order, as in
  the JAX package;
* a conv ``W`` is stored OIHW (PyTorch's layout); the JAX tree holds HWIO
  (``TORCH_LAYOUT``);
* padding follows ``lax``: ``Same`` mode pads ``(out - 1) * s + k_eff - in``
  in total with the smaller half first, ``Truncate`` pads ``padding`` on
  both sides;
* a Dense layer whose activation is an epilogue activation runs through
  ``ops.kernels.matmul.fused_dense`` whatever its dtype (the Hopper kernel
  on CUDA tensors, which raises for a dtype the kernel does not take);
  any other activation (the Output layer's softmax) runs the plain
  product and then the activation, as in the JAX package;
* a 3x3 stride-1 SAME undilated conv whose backward autograd records
  (grad mode on, and x or W requiring grad) runs through
  ``ops.conv_kernels.conv3x3_same``, whose backward is the hand-written
  wgrad/dgrad pair, and adds its bias afterwards, as ``layers.py:313-331``
  of the JAX package does; inference keeps the library conv with its bias;
* LayerNormalization runs ``ops.norm_kernels.fused_layer_norm``: the
  hand-written LayerNorm kernel on CUDA tensors, the plain composition on
  CPU tensors;
* ``train=True`` selects batch statistics in BatchNormalization and input
  dropout (drawn from the ``rng`` generator) in the layers that take it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.core import InputType, Layer
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.ops.kernels.matmul import (EPILOGUE_ACTIVATIONS,
                                                          fused_dense)
from deeplearning4j_tpu_torch.ops.conv_kernels import (conv3x3_eligible,
                                                       conv3x3_same)
from deeplearning4j_tpu_torch.ops.losses import apply_loss, get_loss
from deeplearning4j_tpu_torch.ops.norm_kernels import fused_layer_norm
from deeplearning4j_tpu_torch.ops.pool_kernels import (max_pool2d, pad_nchw,
                                                        resolve_pad)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


# ---------------------------------------------------------------------------
# Dense / Output
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class DenseLayer(Layer):
    """Fully-connected layer.  Non-2D inputs other than [batch, time,
    features] are flattened (NHWC order)."""

    n_out: int = 0
    has_bias: bool = True
    STOCHASTIC = True    # input dropout

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = input_type.flat_size() if input_type.kind != "recurrent" else input_type.shape[-1]
        params = {"W": init_weights(gen, (n_in, self.n_out), self.winit(),
                                    dtype, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype, device=params["W"].device)
        out_type = (InputType.recurrent(self.n_out, input_type.shape[0])
                    if input_type.kind == "recurrent"
                    else InputType.feed_forward(self.n_out))
        return params, {}, out_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        if x.ndim > 2 and x.ndim != 3:
            x = x.reshape(x.shape[0], -1)
        w = params["W"]
        b = params.get("b") if self.has_bias else None
        act = self.activation if self.activation is not None else "identity"
        if isinstance(act, str) and act in EPILOGUE_ACTIVATIONS:
            # every such layer goes to the wrapper: its dispatch runs CPU
            # tensors plainly and raises for CUDA inputs the kernel refuses
            return fused_dense(x.contiguous(), w, bias=b, activation=act), state
        y = x @ w
        if b is not None:
            y = y + b
        return self.act_fn()(y), state


@dataclasses.dataclass(kw_only=True)
class OutputLayer(DenseLayer):
    """Dense + loss head.  At inference it is a Dense layer with its
    configured activation (softmax for the zoo classifiers).  The loss
    takes the raw pre-activations for the logit losses (MCXENT/XENT), the
    stable path, promoted to at least f32."""

    loss: Any = "mcxent"

    def loss_fn(self):
        return get_loss(self.loss)

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        self.loss_fn()
        return super().initialize(gen, input_type, dtype, device)

    def compute_loss(self, params, state, x, labels, *, train=True, rng=None,
                     mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        if x.ndim > 2 and x.ndim != 3:
            x = x.reshape(x.shape[0], -1)
        # the head gets the f32 master W and, under bf16 compute, a bf16
        # input: the product is taken in the promoted type, as jnp does
        acc = torch.promote_types(x.dtype, params["W"].dtype)
        pre = x.to(acc) @ params["W"].to(acc)
        if self.has_bias:
            pre = pre + params["b"]
        # loss math (softmax/log) in >= f32: upcasts bf16 logits, leaves
        # f64 untouched
        pre = pre.to(torch.promote_types(pre.dtype, torch.float32))
        return apply_loss(self.loss, self.act_fn(), pre, labels, mask)


@dataclasses.dataclass(kw_only=True)
class LossLayer(Layer):
    """Loss-only head, no params."""

    loss: Any = "mcxent"
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        get_loss(self.loss)
        return {}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.act_fn()(x), state

    def compute_loss(self, params, state, x, labels, *, train=True, rng=None,
                     mask=None):
        return apply_loss(self.loss, self.act_fn(), x, labels, mask)


@dataclasses.dataclass(kw_only=True)
class ActivationLayer(Layer):
    """Standalone activation; `activation_args` parameterizes it."""

    activation_args: Optional[Dict[str, Any]] = None
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        fn = self.act_fn()
        if self.activation_args:
            return fn(x, **self.activation_args), state
        return fn(x), state


@dataclasses.dataclass(kw_only=True)
class DropoutLayer(Layer):
    """Standalone dropout (`dropout` is the RETAIN probability); the
    identity at inference."""

    dropout: Optional[float] = 0.5
    REGULARIZABLE = ()
    STOCHASTIC = True

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.maybe_input_dropout(x, train, rng), state


# ---------------------------------------------------------------------------
# Convolution (NHWC at the boundary, OIHW weights)
# ---------------------------------------------------------------------------

def _padding_2d(mode: str, padding) -> Any:
    """ConvolutionMode (Same|Truncate|Strict) + explicit padding -> "SAME"
    or ((lo, hi), (lo, hi))."""
    if (mode or "Truncate").lower() == "same":
        return "SAME"
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


@dataclasses.dataclass(kw_only=True)
class ConvolutionLayer(Layer):
    """2-D convolution.  NHWC input and output; `W` stored OIHW."""

    n_out: int = 0
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    dilation: Any = (1, 1)
    convolution_mode: str = "Truncate"  # Same | Truncate | Strict
    has_bias: bool = True

    TORCH_LAYOUT = {"W": (3, 2, 0, 1)}     # HWIO -> OIHW

    def _spatial(self, in_hw):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        ph, pw = _pair(self.padding)
        if self.convolution_mode.lower() == "same":
            oh = -(-in_hw[0] // sh)
            ow = -(-in_hw[1] // sw)
        else:
            eff_kh = (kh - 1) * dh + 1
            eff_kw = (kw - 1) * dw + 1
            oh = (in_hw[0] + 2 * ph - eff_kh) // sh + 1
            ow = (in_hw[1] + 2 * pw - eff_kw) // sw + 1
        return oh, ow

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        kh, kw = _pair(self.kernel_size)
        hwio = init_weights(gen, (kh, kw, c, self.n_out), self.winit("RELU"),
                            dtype, device)
        params = {"W": hwio.permute(*self.TORCH_LAYOUT["W"]).contiguous()}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype, device=hwio.device)
        oh, ow = self._spatial((h, w))
        return params, {}, InputType.convolutional(oh, ow, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        w = params["W"]
        b = params.get("b") if self.has_bias else None
        pad = _padding_2d(self.convolution_mode, self.padding)
        if (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
                and conv3x3_eligible(x.shape, w.shape, None, _pair(self.stride),
                                     pad, _pair(self.dilation))):
            y = conv3x3_same(x, w)
            if b is not None:
                y = y + b
            return self.act_fn()(y), state
        xc = x.permute(0, 3, 1, 2)
        kh, kw = _pair(self.kernel_size)
        dh, dw = _pair(self.dilation)
        pads = resolve_pad(pad, xc.shape[2], xc.shape[3],
                           ((kh - 1) * dh + 1, (kw - 1) * dw + 1),
                           _pair(self.stride))
        (plh, phh), (plw, phw) = pads
        if plh == phh and plw == phw:
            y = F.conv2d(xc, params["W"], b, _pair(self.stride), (plh, plw),
                         (dh, dw))
        else:
            y = F.conv2d(pad_nchw(xc, pads, 0.0), params["W"], b,
                         _pair(self.stride), 0, (dh, dw))
        return self.act_fn()(y.permute(0, 2, 3, 1)), state


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class SubsamplingLayer(Layer):
    """Spatial pooling over NHWC windows: MAX | AVG | SUM | PNORM, with
    lax.reduce_window's padding semantics (AVG counts only real cells)."""

    pooling_type: str = "MAX"
    kernel_size: Any = (2, 2)
    stride: Any = (2, 2)
    padding: Any = (0, 0)
    convolution_mode: str = "Truncate"
    pnorm: int = 2
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        helper = ConvolutionLayer(n_out=c, kernel_size=self.kernel_size,
                                  stride=self.stride, padding=self.padding,
                                  convolution_mode=self.convolution_mode)
        oh, ow = helper._spatial((h, w))
        return {}, {}, InputType.convolutional(oh, ow, c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k = _pair(self.kernel_size)
        s = _pair(self.stride)
        pad = _padding_2d(self.convolution_mode, self.padding)
        pt = self.pooling_type.upper()
        if pt == "MAX":
            return max_pool2d(x, k, s, pad), state
        if pt not in ("AVG", "AVERAGE", "SUM", "PNORM"):
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        xc = x.permute(0, 3, 1, 2)
        pads = resolve_pad(pad, xc.shape[2], xc.shape[3], k, s)

        def window_sum(t):
            return F.avg_pool2d(pad_nchw(t, pads, 0.0), k, s,
                                divisor_override=1)

        if pt in ("AVG", "AVERAGE"):
            y = window_sum(xc) / window_sum(torch.ones_like(xc))
        elif pt == "SUM":
            y = window_sum(xc)
        else:
            p = float(self.pnorm)
            y = window_sum(xc.abs() ** p) ** (1.0 / p)
        return y.permute(0, 2, 3, 1), state


@dataclasses.dataclass(kw_only=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial (or time) dims: MAX | AVG | SUM |
    PNORM.  A [B, T] `mask` on a [B, T, F] input pools only the steps it
    keeps, as the JAX layer does."""

    pooling_type: str = "MAX"
    pnorm: int = 2
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        if input_type.kind in ("convolutional", "recurrent"):
            return {}, {}, InputType.feed_forward(input_type.shape[-1])
        return {}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        dims = tuple(range(1, x.ndim - 1))
        pt = self.pooling_type.upper()
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if pt == "MAX":
                y = torch.amax(torch.where(m > 0, x, -torch.inf), dim=1)
            elif pt in ("AVG", "AVERAGE"):
                y = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
            elif pt == "SUM":
                y = torch.sum(x * m, dim=1)
            else:
                p = float(self.pnorm)
                y = torch.sum((x.abs() ** p) * m, dim=1) ** (1.0 / p)
            return y, state
        if pt == "MAX":
            y = torch.amax(x, dim=dims)
        elif pt in ("AVG", "AVERAGE"):
            y = torch.mean(x, dim=dims)
        elif pt == "SUM":
            y = torch.sum(x, dim=dims)
        elif pt == "PNORM":
            p = float(self.pnorm)
            y = torch.sum(x.abs() ** p, dim=dims) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        return y, state


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class BatchNormalizationLayer(Layer):
    """Batch normalization over the last (channel) axis.  Running stats
    follow the reference's `decay` convention: running = decay * running +
    (1 - decay) * batch.  Statistics are taken in at least f32 (bf16
    compute keeps f32 statistics); running stats keep their dtype."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    REGULARIZABLE = ()
    HAS_STATE = True

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        c = input_type.shape[-1]
        dev = gen.device if device is None else device
        params = {} if self.lock_gamma_beta else {
            "gamma": torch.ones((c,), dtype=dtype, device=dev),
            "beta": torch.zeros((c,), dtype=dtype, device=dev)}
        state = {"mean": torch.zeros((c,), dtype=dtype, device=dev),
                 "var": torch.ones((c,), dtype=dtype, device=dev)}
        return params, state, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        dims = tuple(range(x.ndim - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            # one-pass moments shifted by the running mean (the JAX
            # package's shifted-moments form): E[xs]^2 << E[xs^2] keeps the
            # f32 subtraction from cancelling on large-mean activations
            shift = state["mean"].to(xf.dtype)
            xs = xf - shift
            m1 = torch.mean(xs, dim=dims)
            mean = m1 + shift
            var = torch.clamp(torch.mean(xs * xs, dim=dims) - m1 * m1, min=0.0)
            new_state = {
                "mean": (self.decay * state["mean"] + (1 - self.decay)
                         * mean.detach().to(state["mean"].dtype)),
                "var": (self.decay * state["var"] + (1 - self.decay)
                        * var.detach().to(state["var"].dtype)),
            }
        else:
            mean = state["mean"].to(torch.float32)
            var = state["var"].to(torch.float32)
            new_state = state
        y = ((xf - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        if not self.lock_gamma_beta:
            y = y * params["gamma"] + params["beta"]
        return self.act_fn()(y), new_state


@dataclasses.dataclass(kw_only=True)
class LayerNormalizationLayer(Layer):
    """Layer norm over the feature (last) axis, params ``gamma`` and
    ``beta``."""

    eps: float = 1e-5
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        c = input_type.shape[-1]
        dev = gen.device if device is None else device
        return {"gamma": torch.ones((c,), dtype=dtype, device=dev),
                "beta": torch.zeros((c,), dtype=dtype, device=dev)}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return fused_layer_norm(x, params["gamma"], params["beta"], self.eps), state
