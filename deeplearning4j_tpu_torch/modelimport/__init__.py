"""Model import (the port of ``modelimport/``): TensorFlow GraphDefs and
ONNX models, read by the port's own protobuf codecs (``tf_proto``,
``onnx_proto``), into SameDiff graphs."""
from deeplearning4j_tpu_torch.modelimport.tf_import import (  # noqa: F401
    TFImportRegistry, UnmappedTFOpException, import_graph_def)
from deeplearning4j_tpu_torch.modelimport.onnx_import import (  # noqa: F401
    OnnxImportRegistry, UnmappedOnnxOpException, import_onnx_model)
