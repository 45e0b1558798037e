"""Layer-config NN API of the port (serving slice: the six layer types the
zoo's sequential classifiers use, and MultiLayerNetwork)."""
from deeplearning4j_tpu_torch.nn.core import InputType, Layer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    ActivationLayer, ConvolutionLayer, DenseLayer, DropoutLayer, OutputLayer,
    SubsamplingLayer)

_LAYER_CLASSES = [ActivationLayer, ConvolutionLayer, DenseLayer,
                  DropoutLayer, OutputLayer, SubsamplingLayer]

LAYER_REGISTRY = {c.__name__: c for c in _LAYER_CLASSES}

from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402,F401
    MultiLayerConfiguration, MultiLayerNetwork, NeuralNetConfiguration)
