"""Darknet19 in the PyTorch port against the JAX package at a small input
(32x32x3, 10 classes): `output`, `gradient_for` and one `fit` step in f64,
within 1e-10 relative, from the JAX package's parameters.

Batch 4: at 32x32 the last stage is 1x1, so each BatchNorm there
normalizes over the batch alone, and over 2 samples its output is +-1
whatever the input, which makes the backward ill-conditioned in both
packages alike (their gradients part by 5e-9 relative at batch 2, by
7e-12 at batch 4).  The step uses Nesterovs(1e-2, 0.9), not the zoo's
Adam: every conv feeds a BatchNorm, whose scale invariance leaves weight
gradients near zero, where Adam's g / (|g| + eps) turns their rounding
into 1e-8 relative parameter differences (the Adam step is held to the
JAX package's by SimpleCNN's three steps in `test_torch_zoo_train.py`).
"""
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.train import updaters as jupd

from test_torch_zoo_train import _f64_no_dropout, _images, check_output_gradient_and_step


def test_darknet19_small_input_output_gradient_and_step_match_jax():
    jconf = _f64_no_dropout(jzoo.Darknet19(n_classes=10, input_shape=(32, 32, 3),
                                           updater=jupd.Nesterovs(1e-2, 0.9)).conf())
    check_output_gradient_and_step(jconf, _images(4, 32, 32, 3, 10, seed=7))
