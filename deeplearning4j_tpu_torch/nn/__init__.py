"""Layer-config NN API of the port: the layer types the zoo's sequential
classifiers and ResNet-50 use, LayerNormalization, MultiLayerNetwork
(inference) and ComputationGraph (training and inference)."""
from deeplearning4j_tpu_torch.nn.core import InputType, Layer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    ActivationLayer, BatchNormalizationLayer, ConvolutionLayer, DenseLayer,
    DropoutLayer, GlobalPoolingLayer, LayerNormalizationLayer, LossLayer,
    OutputLayer, SubsamplingLayer)

_LAYER_CLASSES = [ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
                  DenseLayer, DropoutLayer, GlobalPoolingLayer,
                  LayerNormalizationLayer, LossLayer, OutputLayer,
                  SubsamplingLayer]

LAYER_REGISTRY = {c.__name__: c for c in _LAYER_CLASSES}

from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402,F401
    MultiLayerConfiguration, MultiLayerNetwork, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402,F401
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    GraphBuilder, GraphVertex, LayerVertex, MergeVertex, register_vertex)
