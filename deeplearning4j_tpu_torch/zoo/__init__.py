"""Model zoo of the port: the sequential image classifiers LeNet, VGG16 and
VGG19, the graph model ResNet50, and the BERT encoder (inference, and
masked-LM and classification training)."""
from deeplearning4j_tpu_torch.zoo.base import ZOO_REGISTRY, ZooModel, zoo_model  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import LeNet, VGG16, VGG19  # noqa: F401
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.zoo.bert import BertConfig, BertModel  # noqa: F401
