"""Sequential zoo models (the port of ``zoo/models.py``): LeNet, VGG16,
VGG19.  Image models are NHWC; `input_shape` is (H, W, C)."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, DenseLayer,
                                         InputType, Layer,
                                         MultiLayerConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         SubsamplingLayer)
from deeplearning4j_tpu_torch.zoo.base import ZooModel, zoo_model


def _conv(n, k, s=1, pad="same", act="relu", bias=True) -> ConvolutionLayer:
    return ConvolutionLayer(n_out=n, kernel_size=k, stride=s,
                            convolution_mode="Same" if pad == "same" else "Truncate",
                            padding=0 if pad == "same" else pad,
                            activation=act, has_bias=bias)


def _maxpool(k=2, s=2) -> SubsamplingLayer:
    return SubsamplingLayer(pooling_type="MAX", kernel_size=k, stride=s)


@zoo_model
@dataclasses.dataclass
class LeNet(ZooModel):
    """LeNet-5 for MNIST: conv5x5(20) → pool → conv5x5(50) → pool →
    dense(500) → softmax."""

    n_classes: int = 10
    input_shape: Tuple[int, ...] = (28, 28, 1)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self._updater())
                .weight_init("XAVIER")
                .list([
                    ConvolutionLayer(n_out=20, kernel_size=5, stride=1,
                                     activation="identity"),
                    _maxpool(),
                    ConvolutionLayer(n_out=50, kernel_size=5, stride=1,
                                     activation="identity"),
                    _maxpool(),
                    DenseLayer(n_out=500, activation="relu"),
                    OutputLayer(n_out=self.n_classes, loss="mcxent",
                                activation="softmax"),
                ])
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init_model(self, device=None) -> MultiLayerNetwork:
        return self._net(MultiLayerNetwork, self.conf(), device)


def _vgg_blocks(spec: List[Tuple[int, int]]) -> List[Layer]:
    layers: List[Layer] = []
    for n_convs, ch in spec:
        layers += [_conv(ch, 3) for _ in range(n_convs)]
        layers.append(_maxpool())
    return layers


@zoo_model
@dataclasses.dataclass
class VGG16(ZooModel):
    """VGG-16: 13 3x3 convs in five pooled blocks, two 4096-wide relu Dense
    layers (input dropout 0.5, the identity at inference), softmax head."""

    BLOCKS = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self._updater())
                .weight_init("XAVIER")
                .list(_vgg_blocks(self.BLOCKS) + [
                    DenseLayer(n_out=4096, activation="relu", dropout=0.5),
                    DenseLayer(n_out=4096, activation="relu", dropout=0.5),
                    OutputLayer(n_out=self.n_classes, loss="mcxent",
                                activation="softmax"),
                ])
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init_model(self, device=None) -> MultiLayerNetwork:
        return self._net(MultiLayerNetwork, self.conf(), device)


@zoo_model
@dataclasses.dataclass
class VGG19(VGG16):
    """VGG-19."""

    BLOCKS = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]
