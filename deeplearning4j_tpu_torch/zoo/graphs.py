"""DAG zoo models (the port of ``zoo/graphs.py``): ResNet-50, built on
ComputationGraph.  NHWC throughout."""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn import (
    ActivationLayer, BatchNormalizationLayer, ComputationGraph,
    ComputationGraphConfiguration, ConvolutionLayer, ElementWiseVertex,
    GlobalPoolingLayer, GraphBuilder, InputType, OutputLayer, SubsamplingLayer)
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
