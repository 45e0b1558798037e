"""Model import (the port of ``modelimport/``): TensorFlow GraphDefs, read
by the port's own protobuf codec (``tf_proto``), into SameDiff graphs."""
from deeplearning4j_tpu_torch.modelimport.tf_import import (  # noqa: F401
    TFImportRegistry, UnmappedTFOpException, import_graph_def)
