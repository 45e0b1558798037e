"""Feed-forward and convolutional layers (the port of ``nn/layers.py``).

The serving slice ports Dense, Output, Activation, Dropout, Convolution
and Subsampling, with the JAX package's config fields and semantics:

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
  product and then the activation, as in the JAX package.

Forward only: dropout is the identity at inference, and training comes in a
later slice.
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
from deeplearning4j_tpu_torch.ops.losses import get_loss
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

    def apply(self, params, state, x):
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
    configured activation (softmax for the zoo classifiers); the loss is
    validated here and computed by the training slice."""

    loss: Any = "mcxent"

    def loss_fn(self):
        return get_loss(self.loss)

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        self.loss_fn()
        return super().initialize(gen, input_type, dtype, device)


@dataclasses.dataclass(kw_only=True)
class ActivationLayer(Layer):
    """Standalone activation; `activation_args` parameterizes it."""

    activation_args: Optional[Dict[str, Any]] = None

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, input_type

    def apply(self, params, state, x):
        fn = self.act_fn()
        if self.activation_args:
            return fn(x, **self.activation_args), state
        return fn(x), state


@dataclasses.dataclass(kw_only=True)
class DropoutLayer(Layer):
    """Standalone dropout (`dropout` is the RETAIN probability); the
    identity at inference."""

    dropout: Optional[float] = 0.5

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, input_type

    def apply(self, params, state, x):
        return x, state


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

    def apply(self, params, state, x):
        xc = x.permute(0, 3, 1, 2)
        kh, kw = _pair(self.kernel_size)
        dh, dw = _pair(self.dilation)
        pads = resolve_pad(_padding_2d(self.convolution_mode, self.padding),
                           xc.shape[2], xc.shape[3],
                           ((kh - 1) * dh + 1, (kw - 1) * dw + 1),
                           _pair(self.stride))
        (plh, phh), (plw, phw) = pads
        b = params.get("b") if self.has_bias else None
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

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        helper = ConvolutionLayer(n_out=c, kernel_size=self.kernel_size,
                                  stride=self.stride, padding=self.padding,
                                  convolution_mode=self.convolution_mode)
        oh, ow = helper._spatial((h, w))
        return {}, {}, InputType.convolutional(oh, ow, c)

    def apply(self, params, state, x):
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
