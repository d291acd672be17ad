"""PyTorch port, models/convert.py + train/checkpoint.py: reference-format
torch checkpoints written by the JAX package load strictly into the port;
pretraining dumps load their trunk; the weight carrier equals the JAX
package's own exporter; the port's ModelSaver round-trips."""
import numpy as np
import pytest
import torch

from torch_parity import (
    SMALL,
    flax_params,
    jax_logits,
    make_batch,
    torch_logits,
)

from meme_challenge_tpu.models.convert import (
    meme_uniter_params_to_torch,
    save_reference_checkpoint,
    uniter_trunk_params_to_torch,
)
from meme_challenge_tpu.train.checkpoint import ModelSaver as JaxModelSaver
from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.models import convert as C
from meme_challenge_tpu_torch.models.uniter import MemeUniter, init_meme_uniter
from meme_challenge_tpu_torch.train.checkpoint import ModelSaver


def _fresh(seed=9):
    return init_meme_uniter(UniterConfig(**SMALL), 1, "cpu",
                            torch.Generator().manual_seed(seed))


def test_state_from_jax_equals_jax_exporter():
    params = flax_params()
    ours = C.meme_uniter_state_from_jax(params)
    ref = meme_uniter_params_to_torch(params)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert set(ours) == set(MemeUniter(UniterConfig(**SMALL)).state_dict())


def test_reference_checkpoint_from_jax_loads_strictly(tmp_path):
    params = flax_params()
    path = str(tmp_path / "ref.ckpt")
    save_reference_checkpoint(path, params)
    model = _fresh()
    ModelSaver(path).load(model)       # strict=True inside
    batch = make_batch(seed=5)
    np.testing.assert_allclose(torch_logits(model, batch),
                               jax_logits(params, batch), atol=1e-5, rtol=0)
    model2 = _fresh()
    assert C.load_pretrained(model2, path) == "finetuned"
    sd, sd2 = model.state_dict(), model2.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


@pytest.mark.parametrize("trunk_prefix", ["", "uniter."])
def test_pretraining_dump_loads_trunk(tmp_path, trunk_prefix):
    """A raw pretraining dump: ``bert.`` prefix, gamma/beta LayerNorm names,
    optional ``uniter.`` trunk prefix, pretraining heads beside it."""
    params = flax_params()
    trunk = uniter_trunk_params_to_torch(params["uniter"])
    sd = {}
    for k, v in trunk.items():
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma")
        k = k.replace("LayerNorm.bias", "LayerNorm.beta")
        sd["bert." + trunk_prefix + k] = torch.from_numpy(np.array(v))
    sd["bert.cls.predictions.bias"] = torch.zeros(SMALL["vocab_size"])
    sd["bert.itm_output.weight"] = torch.zeros(2, SMALL["hidden_size"])
    path = str(tmp_path / "pretrain.pt")
    torch.save(sd, path)

    model = _fresh()
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("linear.")}
    assert C.load_pretrained(model, path) == "pretrain"
    got = model.state_dict()
    for k, v in trunk.items():
        np.testing.assert_array_equal(got["uniter_model." + k].numpy(),
                                      np.asarray(v), err_msg=k)
    for k, v in head.items():        # the classifier keeps its init
        assert torch.equal(got[k], v)


def test_pretraining_dump_missing_trunk_key_raises(tmp_path):
    trunk = uniter_trunk_params_to_torch(flax_params()["uniter"])
    sd = {"bert." + k: torch.from_numpy(np.array(v))
          for k, v in trunk.items() if "pooler" not in k}
    path = str(tmp_path / "broken.pt")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="pooler"):
        C.load_pretrained(_fresh(), path)


def test_rename_reference_keys():
    sd = {"bert.encoder.LayerNorm.gamma": 1, "bert.x.beta": 2, "y": 3}
    assert C.rename_reference_keys(sd) == {
        "encoder.LayerNorm.weight": 1, "x.bias": 2, "y": 3}
    assert C.rename_reference_keys(sd, strip_prefixes=()) == {
        "bert.encoder.LayerNorm.weight": 1, "bert.x.bias": 2, "y": 3}


def test_model_saver_roundtrip_and_wrapper(tmp_path):
    path = str(tmp_path / "m.ckpt")
    a, b = _fresh(1), _fresh(2)
    ModelSaver(path).save(a)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"model_state_dict"}
    ModelSaver(path).load(b)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_flax_msgpack_checkpoint_raises_clearly(tmp_path):
    """The JAX ModelSaver's flax-msgpack dump of a fine-tuned MemeUniter
    loads (logits within 1e-5 of JAX's); a file that is neither torch nor
    msgpack still raises clearly."""
    path = str(tmp_path / "flax.ckpt")
    JaxModelSaver(path).save(flax_params())
    assert not C.is_torch_checkpoint(path)
    model = _fresh()
    assert C.load_pretrained(model, path) == "finetuned"
    batch = make_batch(seed=4)
    np.testing.assert_allclose(torch_logits(model, batch),
                               jax_logits(flax_params(), batch), atol=1e-5,
                               rtol=0)
    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        f.write(b"\xc1 not a checkpoint")
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        C.load_pretrained(_fresh(), bad)


def test_flax_msgpack_trunk_dump_keeps_the_head(tmp_path):
    """A trunk-only flax dump (a pretraining ``ModelSaver`` file: no
    classifier) loads the trunk, as JAX ``_try_load_flax_params`` reads
    it, and keeps the model's own head."""
    from flax import serialization

    params = flax_params()
    path = str(tmp_path / "trunk.ckpt")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({"params": {
            "uniter": params["uniter"], "mlm_head": {"bias": np.ones(3)}}}))
    model = _fresh(3)
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("linear.")}
    assert C.load_pretrained(model, path) == "pretrain"
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in head.items())
    full = C.meme_uniter_state_from_jax(params)
    for k, v in full.items():
        if not k.startswith("linear."):
            assert torch.equal(sd[k], v), k


def test_flax_msgpack_decoder_matches_flax(tmp_path, monkeypatch):
    """The plain-python decoder against ``flax.serialization``: every
    msgpack type flax writes, its three extension types (ndarray, complex,
    numpy scalar, bfloat16 arrays among them) and chunked leaves."""
    import jax.numpy as jnp
    from flax import serialization

    rng = np.random.RandomState(0)
    tree = {"params": {"w": rng.randn(3, 5).astype(np.float32),
                       "i": np.arange(7, dtype=np.int64),
                       "h": rng.randn(4).astype(np.float16),
                       "b16": jnp.asarray(rng.randn(6), jnp.bfloat16),
                       "s": np.float32(2.5), "n": np.int32(-9)},
            "ints": [0, 127, 128, 255, 65535, 2 ** 32, -1, -33, -129,
                     -40000, -2 ** 40],
            "floats": [1.5, -0.0], "none": None, "flags": [True, False],
            "text": "x" * 40, "z": 2 - 3j,
            "big": rng.randn(300).astype(np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    path = str(tmp_path / "tree.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))
    ours = C.read_flax_msgpack(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    flat_ours, flat_ref = dict(_flatten(ours)), dict(_flatten(ref))
    assert set(flat_ours) == set(flat_ref)
    for k, v in flat_ref.items():
        got = flat_ours[k]
        if v is None or isinstance(v, (str, bool, complex)):
            assert got == v and type(got) is type(v), k
        else:
            np.testing.assert_array_equal(np.asarray(got, np.float64),
                                          np.asarray(v, np.float64),
                                          err_msg=str(k))


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree
