"""GloVe mode in the port against the JAX package, on a small Charades-STA
corpus and a 300-d GloVe file written from a seed (synthetic_tiny widths,
fp32): the dataset-filtered vocab, one step's loss and every gradient
through the frozen table (JAX's `stop_gradient`: a zero gradient), the
optimizer's update of it (none, under Adam and AdamW alike), a
`train(max_steps=2)` run that leaves the table bit-identical, and eval
after it.

Tolerances are tests/test_torch_train.py's: loss and every gradient 1e-4
(fp32, summation order), parameters after one update 1e-4 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.data.pipeline import build_vocab as jax_build_vocab
from drn_tpu.models.drn import location_metadata as jax_location_metadata
from drn_tpu.models.losses import drn_loss as jax_drn_loss
from drn_tpu.parity.convert import torch_state_to_flax
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu.train import make_optimizer as jax_make_optimizer
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.data.pipeline import (BatchIterator, build_vocab,
                                         make_dataset)
from drn_tpu_torch.data.vocab import UNK_ID
from drn_tpu_torch.models import DRN

WORDS = ("person opens the door closes a window reads book walks sits on "
         "chair someone laughs").split()
MISSING = {"someone", "laughs"}  # corpus words without a GloVe row: UNK


def write_corpus(root, n_videos=6, f_dim=128, seed=3):
    rng = np.random.default_rng(seed)
    fd = root / "feats"
    fd.mkdir()
    lines = []
    for v in range(n_videos):
        t = int(rng.integers(5, 50))
        np.save(fd / f"G{v}.npy", rng.normal(size=(t, f_dim)).astype(
            np.float32))
        for _ in range(2):
            s = float(rng.uniform(0, t * 0.5))
            sent = " ".join(rng.choice(WORDS, int(rng.integers(3, 8))))
            lines.append(f"G{v} {s:.2f} {s + t * 0.3:.2f}##{sent}\n")
    (root / "charades_sta_train.txt").write_text("".join(lines))
    (root / "charades_sta_test.txt").write_text("".join(lines[:6]))
    with open(root / "glove.txt", "w") as f:
        for w in [w for w in WORDS if w not in MISSING] + ["unused", "words"]:
            f.write(w + " " + " ".join(
                f"{x:.6f}" for x in rng.normal(size=300)) + "\n")
    return dict(dataset="charades", feature_dir=str(fd), feature_fps=1.0,
                annotation_path=str(root / "charades_sta_{split}.txt"),
                glove_path=str(root / "glove.txt"), batch_size=4)


class Setup:
    def __init__(self, root):
        data = write_corpus(root)
        self.jcfg = jax_get_config("synthetic_tiny")
        self.jcfg = self.jcfg.replace(
            model=dataclasses.replace(self.jcfg.model, dtype="float32"),
            data=dataclasses.replace(self.jcfg.data, **data))
        cfg = get_config("synthetic_tiny")
        self.cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, dtype="float32"),
            data=dataclasses.replace(cfg.data, **data),
            train=dataclasses.replace(cfg.train, checkpoint_dir=str(
                root / "ckpt"), eval_every_epochs=1))
        self.vocab = build_vocab(self.cfg.data, self.cfg.model)
        self.jvocab = jax_build_vocab(self.jcfg.data, self.jcfg.model)
        self.jmodel = jax_build_model(
            self.jcfg, pretrained_embeddings=self.jvocab.embeddings)
        params = jax.device_get(jax_init_params(self.jcfg, self.jmodel,
                                                jax.random.key(0)))
        rng = np.random.default_rng(0)
        # Every leaf but the pretrained table shifted by seeded noise.
        self.params = jax.tree_util.tree_map_with_path(
            lambda path, a: np.asarray(a, np.float32) if any(
                getattr(p, "key", None) == "embedding" for p in path) else
            (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
                np.shape(a))).astype(np.float32), params)
        ds = make_dataset(self.cfg.data, self.cfg.model, vocab=self.vocab)
        self.batch = next(BatchIterator(ds, 4, shuffle=False).epoch(0))

    def model(self):
        mcfg = dataclasses.replace(self.cfg.model,
                                   vocab_size=self.vocab.size)
        m = DRN(mcfg, base_len=self.cfg.data.num_clips,
                freeze_embeddings=True)
        m.load_state_dict(flax_params_to_state_dict(self.params, mcfg))
        return m.train()

    def jax_loss_and_grads(self):
        jl, _, jids = jax_location_metadata(self.jcfg.model,
                                            self.jcfg.data.num_clips)
        jb = {k: jnp.asarray(v) for k, v in self.batch.items()}

        def loss(p):
            out = self.jmodel.apply(p, jb["features"], jb["word_ids"],
                                    jb["query_mask"])
            return jax_drn_loss(self.jcfg.model, self.jcfg.train, out, jl,
                                jids, jb["gt_grid"],
                                self.jcfg.data.num_clips, jb["valid"])

        (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, self.params))
        return jax.device_get(metrics), jax.device_get(grads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return Setup(tmp_path_factory.mktemp("glove"))


@pytest.fixture(scope="module")
def jax_grads(setup):
    return setup.jax_loss_and_grads()


def _assert_trees_close(got, want, atol, rtol):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=jax.tree_util.keystr(path))


def test_build_vocab_equals_jax(setup):
    v, jv = setup.vocab, setup.jvocab
    assert v.word_to_id == jv.word_to_id and v.size == jv.size
    np.testing.assert_array_equal(v.embeddings, jv.embeddings)
    assert not MISSING & set(v.word_to_id)
    assert {"unused", "words"}.isdisjoint(v.word_to_id)
    assert v.embeddings.shape == (len(WORDS) - len(MISSING) + 2, 300)
    ids, _ = v.encode(["someone", "door"], 4)
    assert ids[0] == UNK_ID and ids[1] == v.word_to_id["door"]


def test_build_model_takes_the_pretrained_table(setup):
    model = port_eval.build_model(setup.cfg, device="cpu",
                                  pretrained_embeddings=setup.vocab.embeddings)
    assert model.cfg.vocab_size == setup.vocab.size
    assert model.query_encoder.freeze_embeddings
    np.testing.assert_array_equal(
        model.state_dict()["embed.weight"].numpy(), setup.vocab.embeddings)
    hashed = port_eval.build_model(setup.cfg, device="cpu")
    assert not hashed.query_encoder.freeze_embeddings
    assert hashed.state_dict()["embed.weight"].shape == (128, 300)


def test_loss_and_gradients_match_jax(setup, jax_grads):
    jm, jg = jax_grads
    assert not np.asarray(jg["params"]["query_encoder"]["embedding"][
        "embedding"]).any()  # stop_gradient
    model = setup.model()
    tm = port_train.loss_and_grads(setup.cfg, model,
                                   port_eval.to_device(setup.batch, "cpu"))
    assert model.state_dict(keep_vars=True)["embed.weight"].grad is None
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.state_dict(keep_vars=True).items()}
    _assert_trees_close(torch_state_to_flax(grads, model.cfg), jg,
                        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_one_update_matches_optax_and_keeps_the_table(setup, jax_grads,
                                                      weight_decay):
    """The frozen table stays in the chain with a zero gradient: it adds
    nothing to the clip norm, keeps zero Adam moments and, excluded from
    the decay mask, is not moved by AdamW either."""
    _, jg = jax_grads
    cfg = setup.jcfg.replace(train=dataclasses.replace(
        setup.jcfg.train, weight_decay=weight_decay, grad_clip_norm=0.5))
    tx = jax_make_optimizer(cfg, 2)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)

    @jax.jit
    def update(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    want = jax.device_get(update(jg, params))
    want_norm = float(optax.global_norm(jg))

    tcfg = setup.cfg.replace(train=dataclasses.replace(
        setup.cfg.train, weight_decay=weight_decay, grad_clip_norm=0.5))
    model = setup.model()
    table = model.state_dict()["embed.weight"].clone()
    opt = port_train.make_optimizer(tcfg, 2, model)
    assert "embed.weight" in opt.params
    port_train.loss_and_grads(tcfg, model,
                              port_eval.to_device(setup.batch, "cpu"))
    assert opt.step()
    assert want_norm > 0.5  # it clips
    np.testing.assert_allclose(opt.last_grad_norm.item(), want_norm,
                               rtol=1e-4)
    assert torch.equal(model.state_dict()["embed.weight"], table)
    assert not opt.mu["embed.weight"].any() and \
        not opt.nu["embed.weight"].any()
    _assert_trees_close(torch_state_to_flax(model.state_dict(), model.cfg),
                        want, atol=1e-4, rtol=0)


def test_train_two_steps_keeps_the_table_then_evaluates(setup):
    info = {}
    model = port_train.train(setup.cfg, device="cpu", max_steps=2,
                             run_info=info)
    assert info["step"] == 2
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  setup.vocab.embeddings)
    before = port_eval.build_model(
        setup.cfg, device="cpu", seed=setup.cfg.train.seed,
        pretrained_embeddings=setup.vocab.embeddings).state_dict()
    moved = {k for k in sd if not torch.equal(sd[k], before[k])}
    assert "stem.conv.weight" in moved and "lstm_fwd.0.weight_ih_l0" in moved
    ds = make_dataset(setup.cfg.data, setup.cfg.model, vocab=setup.vocab,
                      split="test")
    res = port_eval.evaluate(setup.cfg, model, ds, device="cpu")
    assert len(res) == 7
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in res.values())


def test_evaluate_cli_in_glove_mode(setup, tmp_path, capsys, monkeypatch):
    # The corpus under a config name of its own: the registry's
    # synthetic_tiny reads the synthetic fixture.
    monkeypatch.setattr(port_eval, "get_config", lambda name: setup.cfg.replace(
        data=dataclasses.replace(setup.cfg.data, feature_dir="",
                                 annotation_path="", glove_path="")))
    model = port_eval.build_model(setup.cfg, device="cpu", seed=4,
                                  pretrained_embeddings=setup.vocab.embeddings)
    path = tmp_path / "glove.pth"
    torch.save({"model": model.state_dict()}, path)
    d = setup.cfg.data
    base = ["--config", "glove_tiny", "--torch-checkpoint", str(path),
            "--device", "cpu", "--feature-dir", d.feature_dir,
            "--annotation-path", d.annotation_path, "--glove-path",
            d.glove_path]
    port_eval.main(base)
    streamed = capsys.readouterr().out
    port_eval.main(base + ["--device-features"])
    staged = capsys.readouterr().out
    assert streamed == staged and len(streamed.strip().splitlines()) == 7
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_eval.main(base[:-2])  # the hashed vocab's table does not fit


def test_train_cli_in_glove_mode_staged(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(port_train, "get_config", lambda name: setup.cfg.replace(
        data=dataclasses.replace(setup.cfg.data, feature_dir="",
                                 annotation_path="", glove_path="")))
    d = setup.cfg.data
    port_train.main(["--config", "glove_tiny", "--max-steps", "2",
                     "--device", "cpu", "--checkpoint-dir", str(tmp_path),
                     "--feature-dir", d.feature_dir, "--annotation-path",
                     d.annotation_path, "--glove-path", d.glove_path,
                     "--feature-fps", "1.0", "--device-features"])
    saved = torch.load(tmp_path / setup.cfg.name / "stage1" / "2.pth",
                       weights_only=True)
    np.testing.assert_array_equal(saved["model"]["embed.weight"].numpy(),
                                  setup.vocab.embeddings)
    assert saved["step"] == 2
    # Worker processes over the staged view: the same two steps.
    port_train.main(["--config", "glove_tiny", "--max-steps", "2",
                     "--device", "cpu", "--checkpoint-dir",
                     str(tmp_path / "workers"), "--feature-dir",
                     d.feature_dir, "--annotation-path", d.annotation_path,
                     "--glove-path", d.glove_path, "--feature-fps", "1.0",
                     "--device-features", "--num-workers", "2"])
    again = torch.load(tmp_path / "workers" / setup.cfg.name / "stage1"
                       / "2.pth", weights_only=True)
    for k, v in saved["model"].items():
        torch.testing.assert_close(again["model"][k], v, rtol=0, atol=0,
                                   msg=k)
