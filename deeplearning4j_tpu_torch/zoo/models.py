"""Sequential zoo models (the port of ``zoo/models.py``): LeNet, SimpleCNN,
AlexNet, VGG16, VGG19, Darknet19 and the char-LM TextGenLSTM.  Image
models are NHWC with `input_shape` (H, W, C); TextGenLSTM's is
(timesteps, vocab)."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from deeplearning4j_tpu_torch.nn import (
    LSTM, BatchNormalizationLayer, ConvolutionLayer, DenseLayer, DropoutLayer,
    GlobalPoolingLayer, InputType, Layer, LocalResponseNormalizationLayer,
    MultiLayerConfiguration, MultiLayerNetwork, NeuralNetConfiguration,
    OutputLayer, RnnOutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
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


@zoo_model
@dataclasses.dataclass
class SimpleCNN(ZooModel):
    """Small CNN: three pairs of 3x3 relu convs with BatchNorm, each pair
    pooled, dropout 0.5, Dense(256, relu), softmax head."""

    n_classes: int = 10
    input_shape: Tuple[int, ...] = (48, 48, 3)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self._updater())
                .weight_init("RELU")
                .list([
                    _conv(16, 3), BatchNormalizationLayer(),
                    _conv(16, 3), BatchNormalizationLayer(), _maxpool(),
                    _conv(32, 3), BatchNormalizationLayer(),
                    _conv(32, 3), BatchNormalizationLayer(), _maxpool(),
                    _conv(64, 3), BatchNormalizationLayer(),
                    _conv(64, 3), BatchNormalizationLayer(), _maxpool(),
                    DropoutLayer(dropout=0.5),
                    DenseLayer(n_out=256, activation="relu"),
                    OutputLayer(n_out=self.n_classes, loss="mcxent",
                                activation="softmax"),
                ])
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init_model(self, device=None) -> MultiLayerNetwork:
        return self._net(MultiLayerNetwork, self.conf(), device)


@zoo_model
@dataclasses.dataclass
class AlexNet(ZooModel):
    """AlexNet, the one-tower variant with LRN: 11x11/4 and 5x5 convs each
    followed by LRN and a 3x3/2 max pool, three 3x3 convs, a pool, two
    4096-wide relu Dense layers with input dropout 0.5, softmax head;
    Nesterovs(1e-2, 0.9) and NORMAL init unless told otherwise."""

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(1e-2, 0.9))
                .weight_init("NORMAL")
                .list([
                    ConvolutionLayer(n_out=96, kernel_size=11, stride=4,
                                     activation="relu"),
                    LocalResponseNormalizationLayer(),
                    _maxpool(3, 2),
                    ConvolutionLayer(n_out=256, kernel_size=5, stride=1,
                                     padding=2, activation="relu"),
                    LocalResponseNormalizationLayer(),
                    _maxpool(3, 2),
                    _conv(384, 3), _conv(384, 3), _conv(256, 3),
                    _maxpool(3, 2),
                    DenseLayer(n_out=4096, activation="relu", dropout=0.5),
                    DenseLayer(n_out=4096, activation="relu", dropout=0.5),
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


@zoo_model
@dataclasses.dataclass
class Darknet19(ZooModel):
    """Darknet-19: conv-BatchNorm-leakyrelu stacks (3x3 Same convs without
    bias, 1x1 bottlenecks), five max pools, a 1x1 conv to the classes,
    global average pooling and a softmax head."""

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape

        def cbl(n, k):
            return [ConvolutionLayer(n_out=n, kernel_size=k,
                                     convolution_mode="Same",
                                     activation="identity", has_bias=False),
                    BatchNormalizationLayer(activation="leakyrelu")]

        layers: List[Layer] = []
        layers += cbl(32, 3) + [_maxpool()]
        layers += cbl(64, 3) + [_maxpool()]
        layers += cbl(128, 3) + cbl(64, 1) + cbl(128, 3) + [_maxpool()]
        layers += cbl(256, 3) + cbl(128, 1) + cbl(256, 3) + [_maxpool()]
        layers += (cbl(512, 3) + cbl(256, 1) + cbl(512, 3) + cbl(256, 1)
                   + cbl(512, 3) + [_maxpool()])
        layers += (cbl(1024, 3) + cbl(512, 1) + cbl(1024, 3) + cbl(512, 1)
                   + cbl(1024, 3))
        layers += [
            ConvolutionLayer(n_out=self.n_classes, kernel_size=1,
                             convolution_mode="Same", activation="identity"),
            GlobalPoolingLayer(pooling_type="AVG"),
            OutputLayer(n_out=self.n_classes, loss="mcxent",
                        activation="softmax"),
        ]
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self._updater())
                .weight_init("RELU")
                .list(layers)
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init_model(self, device=None) -> MultiLayerNetwork:
        return self._net(MultiLayerNetwork, self.conf(), device)


@zoo_model
@dataclasses.dataclass
class TextGenLSTM(ZooModel):
    """Char-LM stacked LSTM: two LSTM(256) layers and an RnnOutputLayer
    over the vocabulary (``BASELINE.json``'s 'Stacked-LSTM char-LM').
    `output` takes windows of any length, the configured T included."""

    n_classes: int = 77          # vocab size
    input_shape: Tuple[int, ...] = (64, 77)   # (timesteps, vocab)
    lstm_units: int = 256

    def conf(self) -> MultiLayerConfiguration:
        t, v = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self._updater())
                .weight_init("XAVIER")
                .list([
                    LSTM(n_out=self.lstm_units, activation="tanh"),
                    LSTM(n_out=self.lstm_units, activation="tanh"),
                    RnnOutputLayer(n_out=self.n_classes, loss="mcxent",
                                   activation="softmax"),
                ])
                .set_input_type(InputType.recurrent(v, t))
                .build())

    def init_model(self, device=None) -> MultiLayerNetwork:
        return self._net(MultiLayerNetwork, self.conf(), device)
