"""The PyTorch port stands alone: no jax, nothing of deeplearning4j_tpu.

An AST scan of every module of the port, chip_smoke.py,
attn_variants.py and paged_variants.py finds no import of either; a fresh interpreter that
imports the whole port has neither in `sys.modules` (nor the kernel build
module, loaded lazily); and the entry points refuse to run without CUDA
unless asked for the CPU (the decode engine's model and KV cache too), and
BERT training runs on the device the model was asked for.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "attn_variants.py",
                                          ROOT / "paged_variants.py", ROOT / "int8_ln_variants.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import deeplearning4j_tpu_torch, deeplearning4j_tpu_torch.convert\n"
        "import deeplearning4j_tpu_torch.nn, deeplearning4j_tpu_torch.zoo\n"
        "import deeplearning4j_tpu_torch.serving, deeplearning4j_tpu_torch.monitor\n"
        "import deeplearning4j_tpu_torch.ops.kernels\n"
        "import deeplearning4j_tpu_torch.ops.conv_kernels, deeplearning4j_tpu_torch.train\n"
        "import deeplearning4j_tpu_torch.nn.graph, deeplearning4j_tpu_torch.zoo.graphs\n"
        "import deeplearning4j_tpu_torch.zoo.bert, deeplearning4j_tpu_torch.ops.norm_kernels\n"
        "import deeplearning4j_tpu_torch.ops.attention_kernels\n"
        "import deeplearning4j_tpu_torch.data, deeplearning4j_tpu_torch.nlp\n"
        "import deeplearning4j_tpu_torch.utils.scan_fit\n"
        "import deeplearning4j_tpu_torch.quant, deeplearning4j_tpu_torch.ops.quant_kernels\n"
        "import deeplearning4j_tpu_torch.serving.decode, deeplearning4j_tpu_torch.serving.resilience\n"
        "import deeplearning4j_tpu_torch.data.analysis, deeplearning4j_tpu_torch.monitor.instrument\n"
        "import deeplearning4j_tpu_torch.ops.kernels.paged_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'deeplearning4j_tpu_torch.ops.kernels.build' not in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel, LeNet, ResNet50

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LeNet().init_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(LeNet().conf())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry().register_zoo("lenet", "LeNet")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50().init_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertModel(BertConfig.tiny())
    # asking for the CPU works
    srv = ModelServer(device="cpu")
    srv.shutdown()
    assert LeNet().init_model(device="cpu").device.type == "cpu"
    assert ModelRegistry().register_zoo("lenet", "LeNet",
                                        device="cpu").model.device.type == "cpu"


def test_bert_training_defaults_to_cuda_and_runs_where_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    import numpy as np

    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel

    model = BertModel(BertConfig.tiny(), device="cpu")
    model.save(str(tmp_path / "bert.zip"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertModel.load(str(tmp_path / "bert.zip"))
    ids = np.random.RandomState(0).randint(0, 100, (2, 8)).astype(np.int32)
    loss = model.fit_batch(MultiDataSet([ids, np.ones((2, 8), np.float32)], [ids],
                                        labels_masks=[np.ones((2, 8), np.float32)]))
    assert loss.device.type == "cpu" and model.iteration == 1


def test_decode_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from deeplearning4j_tpu_torch.serving import (DecodeEngine, PagedKVCache,
                                                  TinyDecodeModel)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TinyDecodeModel(vocab=8, d_model=8, n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(4, page_size=4, n_heads=2, head_dim=4)
    model = TinyDecodeModel(vocab=8, d_model=8, n_heads=2, device="cpu")
    eng = DecodeEngine(model, num_blocks=4, max_seq_len=16)
    try:
        assert eng.cache.k_pages.device.type == "cpu"
        assert len(eng.generate([1, 2], max_new_tokens=2, timeout=30)) == 2
    finally:
        eng.shutdown()
