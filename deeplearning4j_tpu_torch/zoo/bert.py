"""BERT encoder with masked-LM and classification heads (the port of
``zoo/bert.py``): inference and training.

The parameter tree is the JAX package's, name for name and shape for
shape: embeddings, the embedding LayerNorm, the transformer blocks' tensors
STACKED ``[L, ...]`` under ``layers``, the pooler, the MLM head (tied to
``tok_emb``) and the classifier.  They are ``nn.Parameter``s of one
``nn.Module`` (``layers.Wq`` and so on), f32 master copies.  The encoder
loops over the layer slices ``l`` (one ``unbind`` of each stacked tensor,
so autograd stacks the layers' gradients in one pass) where the JAX
package runs ``lax.scan``.

Per block, as in the JAX package: the layer's parameters (LayerNorm gains
included) are cast to ``compute_dtype``; the q/k/v/o and FFN products are
plain library products (``torch.addmm``); attention is
``ops.attention_kernels.fused_attention`` over the [B, S] keep-mask
``input_mask`` cast to ``compute_dtype``; post-LN residuals through
``ops.norm_kernels.fused_layer_norm``; GELU is the tanh approximation
(``jax.nn.gelu``'s default).  The embedding LayerNorm runs in f32 before
the cast; the hidden state returns as f32 and the heads run in f32.  On
CUDA each ``output_hidden`` launches the flash-attention kernel once per
block (12 at base) and the LayerNorm kernel 1 + 2 per block (25);
``output_mlm`` adds one LayerNorm.

Training is the JAX package's step: the masked-LM loss (sparse [B, T] or
one-hot [B, T, V] labels under a [B, T] label mask) when the batch has
``labels_masks``, else the classification loss; autograd of the loss over
the f32 master parameters, then ``updater.apply(opt_state, grads,
iteration, epoch, params=...)``, whose update is subtracted from the
parameters in place under ``torch.no_grad()``.  On CUDA an MLM step's
backward launches the flash-attention dQ and dK/dV kernels once per block
and the LayerNorm backward kernel once per LayerNorm (12, 12 and 26 at
base), beside the forward's 12 and 26.  ``fit_batch`` returns the loss
as a device tensor without synchronising; ``score()`` reads it.
``fit_steps`` runs k steps of a stacked ``[k, batch, ...]`` block in a
Python loop, the same math as k ``fit_batch`` calls.  ``fit`` takes the
JAX package's ``fused_steps`` argument but steps batch by batch: with no
compiled multi-step body, grouping batches into blocks would change
nothing but add host copies.

``save``/``load`` write and read the JAX package's zip: ``config.json``,
``params.npz`` and ``opt.npz`` (the Adam state) with leaves in
``tree_flatten`` order (dict keys sorted), so a zip moves between the two
packages either way, and training resumes from it.
"""
from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
from deeplearning4j_tpu_torch.nn.multilayer import torch_dtype
from deeplearning4j_tpu_torch.ops.attention_kernels import fused_attention
from deeplearning4j_tpu_torch.ops.norm_kernels import fused_layer_norm
from deeplearning4j_tpu_torch.train.updaters import Adam, IUpdater, tree_leaves, tree_map
from deeplearning4j_tpu_torch.utils.devices import resolve_device
from deeplearning4j_tpu_torch.utils.scan_fit import check_steps_axes


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    intermediate: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    eps: float = 1e-12
    compute_dtype: str = "float32"     # "bfloat16" for tensor-core throughput
    n_classes: int = 2                 # classification head width

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """Test-sized config."""
        d = dict(vocab_size=100, hidden=64, n_layers=2, n_heads=4,
                 intermediate=128, max_len=64)
        d.update(kw)
        return BertConfig(**d)


def _shapes(c: BertConfig) -> Dict[str, Any]:
    """Parameter shapes and initial values ("n": normal * 0.02, "0", "1")
    of the JAX package's ``_init``."""
    H, I, L = c.hidden, c.intermediate, c.n_layers
    return {
        "tok_emb": ((c.vocab_size, H), "n"), "pos_emb": ((c.max_len, H), "n"),
        "type_emb": ((c.type_vocab, H), "n"),
        "emb_ln_g": ((H,), "1"), "emb_ln_b": ((H,), "0"),
        "layers": {
            "Wq": ((L, H, H), "n"), "bq": ((L, H), "0"),
            "Wk": ((L, H, H), "n"), "bk": ((L, H), "0"),
            "Wv": ((L, H, H), "n"), "bv": ((L, H), "0"),
            "Wo": ((L, H, H), "n"), "bo": ((L, H), "0"),
            "ln1_g": ((L, H), "1"), "ln1_b": ((L, H), "0"),
            "Wi": ((L, H, I), "n"), "bi": ((L, I), "0"),
            "Wf": ((L, I, H), "n"), "bf": ((L, H), "0"),
            "ln2_g": ((L, H), "1"), "ln2_b": ((L, H), "0"),
        },
        "pool_W": ((H, H), "n"), "pool_b": ((H,), "0"),
        "mlm_W": ((H, H), "n"), "mlm_b": ((H,), "0"),
        "mlm_ln_g": ((H,), "1"), "mlm_ln_b": ((H,), "0"),
        "mlm_bias": ((c.vocab_size,), "0"),
        "cls_W": ((H, c.n_classes), "n"), "cls_b": ((c.n_classes,), "0"),
    }


def _dense(x, w, b):
    """x @ w + b over the last axis, one library product."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


class BertModel(nn.Module):
    """BERT with masked-LM and sequence-classification heads, on `device`
    (``"cuda"`` by default, which raises without CUDA unless the caller
    passes ``device="cpu"``).  Parameters are drawn from `generator`, or
    from a generator seeded with `seed` on the device."""

    def __init__(self, config: BertConfig, seed: int = 0,
                 updater: Optional[IUpdater] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.updater = updater or Adam(1e-4)
        self.iteration = 0
        self.epoch = 0
        gen = generator or torch.Generator(device=self.device).manual_seed(seed)
        self.layers = nn.Module()
        for name, spec in _shapes(config).items():
            holder = self.layers if name == "layers" else self
            for k, (shape, kind) in (spec.items() if name == "layers"
                                     else [(name, spec)]):
                holder.register_parameter(k, nn.Parameter(
                    self._init_tensor(shape, kind, gen)))
        self.opt_state_ = self.updater.init_state(self.params_)
        self._score: Optional[torch.Tensor] = None

    def _init_tensor(self, shape, kind, gen):
        if kind == "n":
            return torch.randn(shape, generator=gen, device=self.device) * 0.02
        fill = torch.ones if kind == "1" else torch.zeros
        return fill(shape, device=self.device)

    @property
    def params_(self) -> Dict[str, Any]:
        """The JAX package's parameter tree: {name: Parameter, ...,
        "layers": {key: stacked [L, ...] Parameter}}."""
        tree = {k: v for k, v in self._parameters.items()}
        tree["layers"] = dict(self.layers._parameters)
        return tree

    # ---- forward ----
    def _encode(self, ids, input_mask, segment_ids=None):
        c = self.config
        dt = torch_dtype(c.compute_dtype)
        p = self.params_
        T = ids.shape[1]
        typ = p["type_emb"][segment_ids] if segment_ids is not None else p["type_emb"][0]
        x = p["tok_emb"][ids] + p["pos_emb"][:T][None] + typ
        x = fused_layer_norm(x, p["emb_ln_g"], p["emb_ln_b"], c.eps)
        x = x.to(dt)
        mask = input_mask.to(dt)
        B, T, H = x.shape
        nh = c.n_heads
        dh = H // nh

        def split(y):
            return y.reshape(B, T, nh, dh).transpose(1, 2)

        layers = {k: v.unbind(0) for k, v in p["layers"].items()}
        for l in range(c.n_layers):
            lp = {k: v[l].to(dt) for k, v in layers.items()}
            q = split(_dense(x, lp["Wq"], lp["bq"]))
            k = split(_dense(x, lp["Wk"], lp["bk"]))
            v = split(_dense(x, lp["Wv"], lp["bv"]))
            a = fused_attention(q, k, v, mask=mask)
            a = a.transpose(1, 2).reshape(B, T, H)
            a = _dense(a, lp["Wo"], lp["bo"])
            x = fused_layer_norm(x + a, lp["ln1_g"], lp["ln1_b"], c.eps)
            h = F.gelu(_dense(x, lp["Wi"], lp["bi"]), approximate="tanh")
            h = _dense(h, lp["Wf"], lp["bf"])
            x = fused_layer_norm(x + h, lp["ln2_g"], lp["ln2_b"], c.eps).to(dt)
        return x.to(torch.float32)

    def _mlm_logits(self, hidden):
        p = self.params_
        h = F.gelu(_dense(hidden, p["mlm_W"], p["mlm_b"]), approximate="tanh")
        h = fused_layer_norm(h, p["mlm_ln_g"], p["mlm_ln_b"], self.config.eps)
        # tied output embedding (BERT standard)
        return _dense(h, p["tok_emb"].t(), p["mlm_bias"])

    def _cls_logits(self, hidden):
        p = self.params_
        pooled = torch.tanh(hidden[:, 0] @ p["pool_W"] + p["pool_b"])
        return pooled @ p["cls_W"] + p["cls_b"]

    # ---- losses ----
    def _mlm_loss(self, ids, input_mask, labels, label_mask):
        """Mean cross-entropy over the positions `label_mask` selects;
        `labels` sparse [B, T] token ids or one-hot [B, T, V]."""
        lp = torch.log_softmax(self._mlm_logits(self._encode(ids, input_mask)), dim=-1)
        if labels.ndim == 2:
            per_tok = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
        else:
            per_tok = -torch.sum(labels * lp, dim=-1)
        denom = torch.clamp(torch.sum(label_mask), min=1.0)
        return torch.sum(per_tok * label_mask) / denom

    def _cls_loss(self, ids, input_mask, labels):
        """Mean cross-entropy of the classifier against one-hot `labels`."""
        logits = self._cls_logits(self._encode(ids, input_mask))
        return -torch.mean(torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1))

    def _batch(self, mds):
        """(loss function, its tensors on the device) of one batch: masked LM
        when the batch has label masks, else classification."""
        def dev(a):
            return torch.as_tensor(a, device=self.device)

        ids, input_mask = (dev(f) for f in mds.features)
        (labels,) = (dev(l) for l in mds.labels)
        if mds.labels_masks is not None:
            return self._mlm_loss, (ids.long(), input_mask, labels, dev(mds.labels_masks[0]))
        return self._cls_loss, (ids.long(), input_mask, labels)

    def _loss_and_grads(self, loss_fn, batch):
        """The loss and d loss / d params as the JAX tree, zeros where a
        parameter does not reach the loss (the other task's head), as
        ``jax.grad`` gives."""
        params = self.params_
        leaves = list(tree_leaves(params))
        loss = loss_fn(*batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(p): torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)}
        return loss.detach(), tree_map(lambda p: by_leaf[id(p)], params)

    def gradient_for(self, mds) -> Dict[str, Any]:
        """d loss / d params of one batch at the current parameters, as the
        JAX tree (no update)."""
        return self._loss_and_grads(*self._batch(mds))[1]

    def _step(self, loss_fn, batch) -> torch.Tensor:
        loss, grads = self._loss_and_grads(loss_fn, batch)
        params = self.params_
        with torch.no_grad():
            upd, self.opt_state_ = self.updater.apply(
                self.opt_state_, grads, self.iteration, self.epoch, params=params)
            tree_map(lambda p, u: p.sub_(u), params, upd)
        self.iteration += 1
        self._score = loss
        return loss

    def _inputs(self, ids, input_mask, segment_ids=None):
        ids = torch.as_tensor(ids, device=self.device).long()
        mask = torch.as_tensor(input_mask, device=self.device)
        seg = (None if segment_ids is None
               else torch.as_tensor(segment_ids, device=self.device).long())
        return ids, mask, seg

    # ---- public API ----
    @torch.inference_mode()
    def output_hidden(self, ids, input_mask, segment_ids=None) -> torch.Tensor:
        """Final hidden states [B, T, hidden] f32.  `ids` [B, T] token ids,
        `input_mask` [B, T] 1/0 keep-mask, `segment_ids` [B, T] or None
        (type embedding 0)."""
        return self._encode(*self._inputs(ids, input_mask, segment_ids))

    @torch.inference_mode()
    def output_mlm(self, ids, input_mask, segment_ids=None) -> torch.Tensor:
        """Masked-LM logits [B, T, vocab_size] f32."""
        return self._mlm_logits(self._encode(*self._inputs(ids, input_mask, segment_ids)))

    @torch.inference_mode()
    def output_cls(self, ids, input_mask, segment_ids=None) -> torch.Tensor:
        """Class probabilities [B, n_classes] f32 (softmax of the
        classifier over the pooled first token)."""
        h = self._encode(*self._inputs(ids, input_mask, segment_ids))
        return torch.softmax(self._cls_logits(h), dim=-1)

    def num_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params_))

    def fit(self, iterator, epochs: int = 1, fused_steps: int = 1) -> "BertModel":
        """Train over `iterator`'s MultiDataSets for `epochs` epochs (the task
        is picked per batch), one `fit_batch` per batch.  `fused_steps` is
        accepted for the JAX package's signature and changes nothing: its
        k-step blocks would run the same k steps."""
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for mds in iterator:
                self.fit_batch(mds)
            self.epoch += 1
        return self

    def fit_batch(self, mds) -> torch.Tensor:
        """One training step on a MultiDataSet: features ``[ids, input_mask]``,
        labels ``[labels]``, and ``labels_masks`` for masked LM.  Returns the
        loss as a device tensor, without synchronising."""
        return self._step(*self._batch(mds))

    def fit_steps(self, mds) -> torch.Tensor:
        """k training steps: every array in `mds` carries a leading
        ``[k, batch]`` steps axis.  The same math as k sequential
        `fit_batch` calls; returns the k losses as a device tensor."""
        lm = None if mds.labels_masks is None else mds.labels_masks[0]
        k = check_steps_axes([("ids", mds.features[0]), ("input_mask", mds.features[1]),
                              ("labels", mds.labels[0]), ("labels_mask", lm)])
        losses = []
        for i in range(k):
            losses.append(self.fit_batch(MultiDataSet(
                features=[f[i] for f in mds.features], labels=[l[i] for l in mds.labels],
                labels_masks=None if lm is None else [m[i] for m in mds.labels_masks])))
        return torch.stack(losses)

    def score(self) -> float:
        """The last step's loss (synchronises); nan before the first step."""
        return float(self._score) if self._score is not None else float("nan")

    # ---- persistence ----
    def save(self, path: str) -> None:
        def npz(tree):
            buf = io.BytesIO()
            np.savez(buf, *[t.detach().float().cpu().numpy() for t in tree_leaves(tree)])
            return buf.getvalue()

        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("config.json", json.dumps(
                {**dataclasses.asdict(self.config),
                 "iteration": self.iteration, "epoch": self.epoch}))
            z.writestr("params.npz", npz(self.params_))
            z.writestr("opt.npz", npz(self.opt_state_))

    @staticmethod
    def load(path: str, device=None) -> "BertModel":
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("config.json").decode())
            iteration = meta.pop("iteration")
            epoch = meta.pop("epoch")
            model = BertModel(BertConfig(**meta), device=device)
            with np.load(io.BytesIO(z.read("params.npz"))) as d:
                _copy_leaves(model.params_, d)
            with np.load(io.BytesIO(z.read("opt.npz"))) as d:
                _copy_leaves(model.opt_state_, d)
        model.iteration, model.epoch = iteration, epoch
        return model


@torch.no_grad()
def _copy_leaves(tree, npz) -> None:
    leaves = list(tree_leaves(tree))
    if len(npz.files) != len(leaves):
        raise ValueError(f"zip holds {len(npz.files)} arrays, the model {len(leaves)}")
    for i, t in enumerate(leaves):
        arr = npz[f"arr_{i}"]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.asarray(arr)))

