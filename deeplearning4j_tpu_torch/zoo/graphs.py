"""DAG zoo models (the port of ``zoo/graphs.py``): ResNet-50, SqueezeNet
v1.1 and U-Net, built on ComputationGraph.  NHWC throughout.  Each
configuration is the JAX package's, so ``conf().to_json()`` gives the same
string in both packages and parameters cross with ``convert``."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_tpu_torch.nn import (
    ActivationLayer, BatchNormalizationLayer, ComputationGraph,
    ComputationGraphConfiguration, ConvolutionLayer, Deconvolution2DLayer,
    DropoutLayer, ElementWiseVertex, GlobalPoolingLayer, GraphBuilder, InputType,
    LossLayer, MergeVertex, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.zoo.base import ZooModel, zoo_model


def _conv_bn(b: GraphBuilder, name: str, inp: str, n: int, k, s=1,
             act: str = "relu", mode: str = "Same") -> str:
    """conv (no bias) -> BN (act) pair; returns the output vertex name.  BN
    takes the bias's role, as the reference ResNet does."""
    b.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n, kernel_size=k, stride=s,
                                 convolution_mode=mode, activation="identity",
                                 has_bias=False), inp)
    b.add_layer(f"{name}_bn", BatchNormalizationLayer(activation=act),
                f"{name}_conv")
    return f"{name}_bn"


@zoo_model
@dataclasses.dataclass
class ResNet50(ZooModel):
    """ResNet-50 (He et al. 2015 bottleneck v1).  `STAGES` is (blocks,
    width) per stage; a subclass may change it (the tests build a shallow,
    narrow one in both packages)."""

    STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

    def _bottleneck(self, b: GraphBuilder, name: str, inp: str, ch: int,
                    stride: int, project: bool) -> str:
        x = _conv_bn(b, f"{name}_a", inp, ch, 1, stride)
        x = _conv_bn(b, f"{name}_b", x, ch, 3, 1)
        x = _conv_bn(b, f"{name}_c", x, ch * 4, 1, 1, act="identity")
        if project:
            short = _conv_bn(b, f"{name}_proj", inp, ch * 4, 1, stride,
                             act="identity")
        else:
            short = inp
        b.add_vertex(f"{name}_add", ElementWiseVertex(op="Add"), x, short)
        b.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_relu"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        b = (GraphBuilder().seed(self.seed).updater(self._updater())
             .weight_init("RELU")
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _conv_bn(b, "stem", "input", 64, 7, 2)
        b.add_layer("stem_pool",
                    SubsamplingLayer(pooling_type="MAX", kernel_size=3,
                                     stride=2, convolution_mode="Same"), x)
        x = "stem_pool"
        for si, (blocks, ch) in enumerate(self.STAGES):
            for bi in range(blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = self._bottleneck(b, f"s{si}b{bi}", x, ch, stride,
                                     project=(bi == 0))
        b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="AVG"), x)
        b.add_layer("output",
                    OutputLayer(n_out=self.n_classes, loss="mcxent",
                                activation="softmax"), "avgpool")
        b.set_outputs("output")
        return b.build()

    def init_model(self, device=None) -> ComputationGraph:
        return self._net(ComputationGraph, self.conf(), device)


@zoo_model
@dataclasses.dataclass
class SqueezeNet(ZooModel):
    """SqueezeNet v1.1 (reference `zoo/model/SqueezeNet.java`): fire modules
    (1x1 squeeze -> parallel 1x1 / 3x3 expands -> channel merge).  Its
    DropoutLayer draws from the network's generator in training."""

    def _fire(self, b: GraphBuilder, name: str, inp: str, sq: int,
              ex: int) -> str:
        b.add_layer(f"{name}_sq", ConvolutionLayer(
            n_out=sq, kernel_size=1, activation="relu",
            convolution_mode="Same"), inp)
        b.add_layer(f"{name}_e1", ConvolutionLayer(
            n_out=ex, kernel_size=1, activation="relu",
            convolution_mode="Same"), f"{name}_sq")
        b.add_layer(f"{name}_e3", ConvolutionLayer(
            n_out=ex, kernel_size=3, activation="relu",
            convolution_mode="Same"), f"{name}_sq")
        b.add_vertex(f"{name}_m", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_m"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        b = (GraphBuilder().seed(self.seed).updater(self._updater())
             .weight_init("RELU")
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        b.add_layer("stem", ConvolutionLayer(
            n_out=64, kernel_size=3, stride=2, activation="relu",
            convolution_mode="Same"), "input")
        b.add_layer("pool1", SubsamplingLayer(
            pooling_type="MAX", kernel_size=3, stride=2), "stem")
        x = self._fire(b, "fire2", "pool1", 16, 64)
        x = self._fire(b, "fire3", x, 16, 64)
        b.add_layer("pool3", SubsamplingLayer(
            pooling_type="MAX", kernel_size=3, stride=2), x)
        x = self._fire(b, "fire4", "pool3", 32, 128)
        x = self._fire(b, "fire5", x, 32, 128)
        b.add_layer("pool5", SubsamplingLayer(
            pooling_type="MAX", kernel_size=3, stride=2), x)
        x = self._fire(b, "fire6", "pool5", 48, 192)
        x = self._fire(b, "fire7", x, 48, 192)
        x = self._fire(b, "fire8", x, 64, 256)
        x = self._fire(b, "fire9", x, 64, 256)
        b.add_layer("drop", DropoutLayer(dropout=0.5), x)
        b.add_layer("conv10", ConvolutionLayer(
            n_out=self.n_classes, kernel_size=1, activation="relu",
            convolution_mode="Same"), "drop")
        b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="AVG"),
                    "conv10")
        b.add_layer("output", LossLayer(loss="mcxent", activation="softmax"),
                    "avgpool")
        b.set_outputs("output")
        return b.build()

    def init_model(self, device=None) -> ComputationGraph:
        return self._net(ComputationGraph, self.conf(), device)


@zoo_model
@dataclasses.dataclass
class UNet(ZooModel):
    """U-Net (reference `zoo/model/UNet.java`): a 4-level encoder/decoder
    with skip-connection merges and a per-pixel sigmoid head.  The
    reference's width is ``base_filters=64`` at 512x512x3; the defaults are
    the JAX package's lighter ones."""

    n_classes: int = 1
    input_shape: Tuple[int, ...] = (128, 128, 3)
    base_filters: int = 32

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        f = self.base_filters
        b = (GraphBuilder().seed(self.seed).updater(self._updater())
             .weight_init("RELU")
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))

        def double_conv(name, inp, n):
            x = _conv_bn(b, f"{name}_1", inp, n, 3)
            return _conv_bn(b, f"{name}_2", x, n, 3)

        skips = []
        x = "input"
        for i, n in enumerate([f, f * 2, f * 4, f * 8]):
            x = double_conv(f"enc{i}", x, n)
            skips.append(x)
            b.add_layer(f"enc{i}_pool", SubsamplingLayer(
                pooling_type="MAX", kernel_size=2, stride=2), x)
            x = f"enc{i}_pool"
        x = double_conv("mid", x, f * 16)
        for i, n in zip(range(3, -1, -1), [f * 8, f * 4, f * 2, f]):
            b.add_layer(f"dec{i}_up", Deconvolution2DLayer(
                n_out=n, kernel_size=2, stride=2, activation="relu"), x)
            b.add_vertex(f"dec{i}_cat", MergeVertex(), f"dec{i}_up", skips[i])
            x = double_conv(f"dec{i}", f"dec{i}_cat", n)
        b.add_layer("head", ConvolutionLayer(
            n_out=self.n_classes, kernel_size=1, activation="identity",
            convolution_mode="Same"), x)
        b.add_layer("output", LossLayer(loss="xent", activation="sigmoid"),
                    "head")
        b.set_outputs("output")
        return b.build()

    def init_model(self, device=None) -> ComputationGraph:
        return self._net(ComputationGraph, self.conf(), device)
