"""Model zoo of the port: the sequential image classifiers LeNet,
SimpleCNN, AlexNet, VGG16, VGG19 and Darknet19, the char-LM TextGenLSTM,
the graph models ResNet50, SqueezeNet and UNet, and the BERT encoder
(inference, and masked-LM and classification training)."""
from deeplearning4j_tpu_torch.zoo.base import ZOO_REGISTRY, ZooModel, zoo_model  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    AlexNet, Darknet19, LeNet, SimpleCNN, TextGenLSTM, VGG16, VGG19)
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50, SqueezeNet, UNet  # noqa: F401
from deeplearning4j_tpu_torch.zoo.bert import BertConfig, BertModel  # noqa: F401
