"""Layer-config NN API of the port: every layer of the JAX package's
``nn/layers.py`` and ``nn/shape_ops.py``, MultiLayerNetwork and
ComputationGraph (training, inference and evaluation)."""
from deeplearning4j_tpu_torch.nn.core import InputType, Layer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    ActivationLayer, BatchNormalizationLayer, Convolution1DLayer,
    ConvolutionLayer, Deconvolution2DLayer, DenseLayer,
    DepthwiseConvolution2DLayer, DropoutLayer, ElementWiseMultiplicationLayer,
    EmbeddingLayer, EmbeddingSequenceLayer, GlobalPoolingLayer,
    LayerNormalizationLayer, LocalResponseNormalizationLayer, LossLayer,
    OutputLayer, SeparableConvolution2DLayer, SubsamplingLayer,
    Upsampling2DLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.shape_ops import (  # noqa: F401
    FlattenLayer, PermuteLayer, RepeatVectorLayer, ReshapeLayer,
    TimeDistributed, input_type_from_shape)

_LAYER_CLASSES = [
    ActivationLayer, BatchNormalizationLayer, Convolution1DLayer,
    ConvolutionLayer, Deconvolution2DLayer, DenseLayer,
    DepthwiseConvolution2DLayer, DropoutLayer, ElementWiseMultiplicationLayer,
    EmbeddingLayer, EmbeddingSequenceLayer, GlobalPoolingLayer,
    LayerNormalizationLayer, LocalResponseNormalizationLayer, LossLayer,
    OutputLayer, SeparableConvolution2DLayer, SubsamplingLayer,
    Upsampling2DLayer, ZeroPaddingLayer,
    FlattenLayer, PermuteLayer, RepeatVectorLayer, ReshapeLayer,
    TimeDistributed,
]

LAYER_REGISTRY = {c.__name__: c for c in _LAYER_CLASSES}

from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402,F401
    MultiLayerConfiguration, MultiLayerNetwork, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402,F401
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    GraphBuilder, GraphVertex, LayerVertex, MergeVertex, register_vertex)
