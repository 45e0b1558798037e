"""Feed-forward and convolutional layers (the port of ``nn/layers.py``).

Every layer of the JAX package's ``nn/layers.py``: Dense, Output, Loss,
Activation, Dropout, ElementWiseMultiplication, Embedding,
EmbeddingSequence, Convolution, Convolution1D, DepthwiseConvolution2D,
SeparableConvolution2D, Deconvolution2D, Subsampling, GlobalPooling,
Upsampling2D, ZeroPadding, BatchNormalization, LocalResponseNormalization
and LayerNormalization, with the JAX package's config fields, JSON and
semantics:

* activations are NHWC at every layer boundary.  Convolution and pooling
  run on an NCHW view of the NHWC tensor (``permute``; a channels-last
  view, no copy), so a flatten before a Dense layer sees NHWC order, as in
  the JAX package;
* a conv ``W`` is stored OIHW (PyTorch's layout); the JAX tree holds HWIO
  (``TORCH_LAYOUT``; Convolution1D [O, I, k] for WIO, Deconvolution2D
  [I, O, kh, kw]).  The depthwise and separable convs run ``groups`` =
  channels, which orders output channels as ``feature_group_count`` does;
* the layers without a kernel of their own (all but Dense, Convolution
  and LayerNormalization) are plain torch ops on any device;
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
from deeplearning4j_tpu_torch.utils.data_parallel import global_moments


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

    def prepare(self, x, train=False, rng=None):
        """Input dropout, then a flatten of inputs other than [batch, time,
        features]."""
        x = self.maybe_input_dropout(x, train, rng)
        if x.ndim > 2 and x.ndim != 3:
            x = x.reshape(x.shape[0], -1)
        return x

    def epilogue(self) -> Optional[str]:
        """The activation where ``fused_dense`` applies it in its epilogue
        (an elementwise one), else None."""
        act = self.activation if self.activation is not None else "identity"
        return act if isinstance(act, str) and act in EPILOGUE_ACTIVATIONS else None

    def pre_activation(self, params, x):
        """x @ W + b on a prepared input, the plain product."""
        y = x @ params["W"]
        return y + params["b"] if self.has_bias else y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.prepare(x, train, rng)
        act = self.epilogue()
        if act is not None:
            # every such layer goes to the wrapper: its dispatch runs CPU
            # tensors plainly and raises for CUDA inputs the kernel refuses
            b = params["b"] if self.has_bias else None
            return fused_dense(x.contiguous(), params["W"], bias=b, activation=act), state
        return self.act_fn()(self.pre_activation(params, x)), state


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

    def logits(self, params, x):
        """The loss's input from a prepared input: x @ W + b."""
        # the head gets the f32 master W and, under bf16 compute, a bf16
        # input: the product is taken in the promoted type, as jnp does
        acc = torch.promote_types(x.dtype, params["W"].dtype)
        pre = x.to(acc) @ params["W"].to(acc)
        if self.has_bias:
            pre = pre + params["b"]
        # loss math (softmax/log) in >= f32: upcasts bf16 logits, leaves
        # f64 untouched
        return pre.to(torch.promote_types(pre.dtype, torch.float32))

    def compute_loss(self, params, state, x, labels, *, train=True, rng=None,
                     mask=None):
        return apply_loss(self.loss, self.act_fn(),
                          self.logits(params, self.prepare(x, train, rng)), labels, mask)


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


@dataclasses.dataclass(kw_only=True)
class ElementWiseMultiplicationLayer(Layer):
    """Per-feature learned scale ``W`` (ones at init) and bias ``b``."""

    STOCHASTIC = True

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        n = input_type.flat_size()
        dev = gen.device if device is None else device
        params = {"W": torch.ones((n,), dtype=dtype, device=dev),
                  "b": torch.full((n,), self.bias_init, dtype=dtype, device=dev)}
        return params, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        return self.act_fn()(x * params["W"] + params["b"]), state


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def _table(layer, gen, dtype, device):
    """An embedding layer's params: the [n_in, n_out] table ``W`` and, with
    `has_bias`, ``b``."""
    params = {"W": init_weights(gen, (layer.n_in, layer.n_out), layer.winit(),
                                dtype, device)}
    if layer.has_bias:
        params["b"] = torch.full((layer.n_out,), layer.bias_init, dtype=dtype,
                                 device=params["W"].device)
    return params


def _gather_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W[x]`` with ``jnp`` indexing's rules: indices truncate to integers
    and a negative one wraps once; one still out of range reads the
    nearest row (the gather clamps) and sends no gradient back (the
    scatter-add of the backward drops it).  A torch index out of range
    would raise, or on the card assert and poison the CUDA context."""
    n = w.shape[0]
    idx = x.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = ((idx >= 0) & (idx < n))[..., None]
    rows = w[idx.clamp(0, n - 1)]
    return torch.where(inside, rows, rows.detach())


@dataclasses.dataclass(kw_only=True)
class EmbeddingLayer(Layer):
    """Index -> vector lookup: a [batch] or [batch, 1] index input gives
    [batch, n_out]."""

    n_in: int = 0   # vocab size
    n_out: int = 0
    has_bias: bool = False

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return _table(self, gen, dtype, device), {}, InputType.feed_forward(self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.ndim == 2 and x.shape[-1] == 1:
            x = x[..., 0]
        y = _gather_rows(params["W"], x)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state


@dataclasses.dataclass(kw_only=True)
class EmbeddingSequenceLayer(Layer):
    """A [batch, time] index sequence -> [batch, time, n_out]."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = False

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        t = input_type.shape[0] if input_type.kind == "recurrent" else None
        return _table(self, gen, dtype, device), {}, InputType.recurrent(self.n_out, t)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = _gather_rows(params["W"], x)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state


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


def _conv_nhwc(x, w, b, stride, pad, dilation=(1, 1), groups=1):
    """NHWC `x` conv OIHW `w` (+ `b`) -> NHWC, with lax's padding for
    `pad` ("SAME" or ((lo, hi), (lo, hi))): a symmetric pad goes to
    ``F.conv2d``, an asymmetric one is applied first."""
    xc = x.permute(0, 3, 1, 2)
    kh, kw = w.shape[2], w.shape[3]
    dh, dw = dilation
    pads = resolve_pad(pad, xc.shape[2], xc.shape[3],
                       ((kh - 1) * dh + 1, (kw - 1) * dw + 1), stride)
    (plh, phh), (plw, phw) = pads
    if plh == phh and plw == phw:
        y = F.conv2d(xc, w, b, stride, (plh, plw), dilation, groups)
    else:
        y = F.conv2d(pad_nchw(xc, pads, 0.0), w, b, stride, 0, dilation, groups)
    return y.permute(0, 2, 3, 1)


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
        y = _conv_nhwc(x, w, b, _pair(self.stride), pad, _pair(self.dilation))
        return self.act_fn()(y), state


@dataclasses.dataclass(kw_only=True)
class Convolution1DLayer(Layer):
    """1-D conv over [batch, time, features]; `W` stored [O, I, k] (the
    JAX package's is WIO)."""

    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "Same"
    has_bias: bool = True

    TORCH_LAYOUT = {"W": (2, 1, 0)}        # WIO -> OIW

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        f = input_type.shape[-1]
        k = int(self.kernel_size)
        wio = init_weights(gen, (k, f, self.n_out), self.winit("RELU"), dtype, device)
        params = {"W": wio.permute(*self.TORCH_LAYOUT["W"]).contiguous()}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                     device=wio.device)
        t = input_type.shape[0]
        if t is not None:
            if self.convolution_mode.lower() == "same":
                t = -(-t // int(self.stride))
            else:
                eff_k = (k - 1) * int(self.dilation) + 1
                t = (t + 2 * int(self.padding) - eff_k) // int(self.stride) + 1
        return params, {}, InputType.recurrent(self.n_out, t)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        s, d = int(self.stride), int(self.dilation)
        k = params["W"].shape[-1]
        if self.convolution_mode.lower() == "same":
            (lo, hi), _ = resolve_pad("SAME", x.shape[1], 1, ((k - 1) * d + 1, 1), (s, 1))
        else:
            lo = hi = int(self.padding)
        xc = F.pad(x.permute(0, 2, 1), (lo, hi))
        b = params.get("b") if self.has_bias else None
        y = F.conv1d(xc, params["W"], b, s, 0, d)
        return self.act_fn()(y.permute(0, 2, 1)), state


@dataclasses.dataclass(kw_only=True)
class DepthwiseConvolution2DLayer(Layer):
    """Depthwise conv: `depth_multiplier` filters per input channel, output
    channel o reading input channel o // depth_multiplier (``groups`` =
    channels, as the JAX package's ``feature_group_count``).  `W` stored
    [C*m, 1, kh, kw] (the JAX package's is HWIO [kh, kw, 1, C*m])."""

    depth_multiplier: int = 1
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    convolution_mode: str = "Truncate"
    has_bias: bool = True

    TORCH_LAYOUT = {"W": (3, 2, 0, 1)}     # HWIO -> OIHW

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        kh, kw = _pair(self.kernel_size)
        n_out = c * self.depth_multiplier
        hwio = init_weights(gen, (kh, kw, 1, n_out), self.winit("RELU"), dtype, device)
        params = {"W": hwio.permute(*self.TORCH_LAYOUT["W"]).contiguous()}
        if self.has_bias:
            params["b"] = torch.full((n_out,), self.bias_init, dtype=dtype,
                                     device=hwio.device)
        helper = ConvolutionLayer(n_out=n_out, kernel_size=self.kernel_size,
                                  stride=self.stride, padding=self.padding,
                                  convolution_mode=self.convolution_mode)
        oh, ow = helper._spatial((h, w))
        return params, {}, InputType.convolutional(oh, ow, n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        b = params.get("b") if self.has_bias else None
        y = _conv_nhwc(x, params["W"], b, _pair(self.stride),
                       _padding_2d(self.convolution_mode, self.padding),
                       groups=x.shape[-1])
        return self.act_fn()(y), state


@dataclasses.dataclass(kw_only=True)
class SeparableConvolution2DLayer(Layer):
    """Depthwise-separable conv: a depthwise conv (`W_depth`, depth
    multiplier m) then a 1x1 conv (`W_point`) to `n_out` channels, then the
    bias.  Both stored OIHW (the JAX package's are HWIO)."""

    n_out: int = 0
    depth_multiplier: int = 1
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    convolution_mode: str = "Truncate"
    has_bias: bool = True

    REGULARIZABLE = ("W_depth", "W_point")
    TORCH_LAYOUT = {"W_depth": (3, 2, 0, 1), "W_point": (3, 2, 0, 1)}

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        kh, kw = _pair(self.kernel_size)
        mid = c * self.depth_multiplier
        depth = init_weights(gen, (kh, kw, 1, mid), self.winit("RELU"), dtype, device)
        point = init_weights(gen, (1, 1, mid, self.n_out), self.winit("RELU"), dtype,
                             device)
        params = {"W_depth": depth.permute(*self.TORCH_LAYOUT["W_depth"]).contiguous(),
                  "W_point": point.permute(*self.TORCH_LAYOUT["W_point"]).contiguous()}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                     device=depth.device)
        helper = ConvolutionLayer(n_out=self.n_out, kernel_size=self.kernel_size,
                                  stride=self.stride, padding=self.padding,
                                  convolution_mode=self.convolution_mode)
        oh, ow = helper._spatial((h, w))
        return params, {}, InputType.convolutional(oh, ow, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        y = _conv_nhwc(x, params["W_depth"], None, _pair(self.stride),
                       _padding_2d(self.convolution_mode, self.padding),
                       groups=x.shape[-1])
        y = _conv_nhwc(y, params["W_point"], None, (1, 1), "VALID")
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state


def _transpose_pads(mode: str, k: int, s: int, p: int) -> Tuple[int, int]:
    """(lo, hi) padding of the stride-dilated input in the JAX package's
    transposed conv: ``lax.conv_transpose``'s own rule for SAME, and
    k - 1 - p on both sides otherwise (output s * (in - 1) + k - 2p)."""
    if mode.lower() == "same":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
        return lo, pad_len - lo
    return k - 1 - p, k - 1 - p


@dataclasses.dataclass(kw_only=True)
class Deconvolution2DLayer(Layer):
    """Transposed conv in the gradient form (TF/Keras): each input pixel
    scatters W times itself into a stride-spaced output.  `W` stored
    [Cin, Cout, kh, kw], ``F.conv_transpose2d``'s layout (the JAX package's
    is HWIO [kh, kw, Cin, Cout], flipped there for ``lax.conv_transpose``).
    The full transposed conv (every tap, (in - 1) * s + k) is cropped, or
    zero-padded, to the JAX package's padding."""

    n_out: int = 0
    kernel_size: Any = (2, 2)
    stride: Any = (2, 2)
    padding: Any = (0, 0)
    convolution_mode: str = "Truncate"
    has_bias: bool = True

    TORCH_LAYOUT = {"W": (2, 3, 0, 1)}     # HWIO -> IOHW

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        hwio = init_weights(gen, (kh, kw, c, self.n_out), self.winit("RELU"), dtype,
                            device)
        params = {"W": hwio.permute(*self.TORCH_LAYOUT["W"]).contiguous()}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                     device=hwio.device)
        if self.convolution_mode.lower() == "same":
            oh, ow = h * sh, w * sw
        else:
            oh = sh * (h - 1) + kh - 2 * ph
            ow = sw * (w - 1) + kw - 2 * pw
        return params, {}, InputType.convolutional(oh, ow, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_input_dropout(x, train, rng)
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        loh, hih = _transpose_pads(self.convolution_mode, kh, sh, ph)
        low, hiw = _transpose_pads(self.convolution_mode, kw, sw, pw)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), params["W"], None, (sh, sw))
        # the full output pads k - 1 on each side; F.pad crops where the
        # JAX package pads less
        y = F.pad(y, (low - (kw - 1), hiw - (kw - 1), loh - (kh - 1), hih - (kh - 1)))
        y = y.permute(0, 2, 3, 1)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state


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

@dataclasses.dataclass(kw_only=True)
class Upsampling2DLayer(Layer):
    """Nearest-neighbour upsampling by `size` (each pixel repeated)."""

    size: Any = (2, 2)
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        sh, sw = _pair(self.size)
        return {}, {}, InputType.convolutional(h * sh, w * sw, c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), state


@dataclasses.dataclass(kw_only=True)
class ZeroPaddingLayer(Layer):
    """Spatial zero padding.  `padding` is an int, a symmetric (ph, pw)
    pair, or per side ((top, bottom), (left, right))."""

    padding: Any = (1, 1)
    REGULARIZABLE = ()

    def _sides(self):
        ph, pw = _pair(self.padding) if not (
            isinstance(self.padding, (tuple, list))
            and len(self.padding) == 2
            and isinstance(self.padding[0], (tuple, list))) else self.padding
        top, bot = _pair(ph)
        left, right = _pair(pw)
        return (int(top), int(bot)), (int(left), int(right))

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        h, w, c = input_type.shape
        (t, b), (le, r) = self._sides()
        return {}, {}, InputType.convolutional(h + t + b, w + le + r, c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        (t, b), (le, r) = self._sides()
        return F.pad(x, (0, 0, le, r, t, b)), state


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class BatchNormalizationLayer(Layer):
    """Batch normalization over the last (channel) axis.  Running stats
    follow the reference's `decay` convention: running = decay * running +
    (1 - decay) * batch.  Statistics are taken in at least f32 (bf16
    compute keeps f32 statistics); running stats keep their dtype.  In a
    data-parallel step of more than one rank the training statistics are
    the global batch's (``utils/data_parallel.global_moments``), so the
    running statistics stay equal on every rank."""

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
            moments = global_moments(xs, dims)
            if moments is None:
                m1, m2 = torch.mean(xs, dim=dims), torch.mean(xs * xs, dim=dims)
            else:
                # a data-parallel step: the global batch's moments
                m1, m2 = moments
            mean = m1 + shift
            var = torch.clamp(m2 - m1 * m1, min=0.0)
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
class LocalResponseNormalizationLayer(Layer):
    """LRN across channels: x / (k + alpha * sum of x^2 over `n` adjacent
    channels) ** beta, the window zero-padded at the ends (NHWC, last
    axis)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    REGULARIZABLE = ()

    def initialize(self, gen, input_type, dtype=torch.float32, device=None):
        return {}, {}, input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        half = self.n // 2
        c = x.shape[-1]
        padded = F.pad(x * x, (half, half))
        window = sum(padded[..., i:i + c] for i in range(self.n))
        return x / (self.k + self.alpha * window) ** self.beta, state


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
