"""The port's export, registry and API keys against the JAX package's: one
tiny student carried over from JAX params exports the same weights_int8.npz
(keys, int8 values bit for bit, scales exactly), each package reads the
other's file, and the parity check agrees within 1e-5; the registry writes
the same registry.json (timestamps aside) and hashes a JAX checkpoint alike;
a key made by either package verifies in the other."""

import json

import jax
import numpy as np
import pytest

from sskd_tpu.keys import APIKeyManager as JKeys
from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.models.export import dequantize_param_tree as j_dequantize
from sskd_tpu.models.export import export_student_model as j_export
from sskd_tpu.models.export import load_quantized_weights as j_load
from sskd_tpu.registry import ModelRegistry as JRegistry
from sskd_tpu.serve.middleware import APIKeyAuth as JAuth
from sskd_tpu_torch.exceptions import ModelError, ModelNotFoundError, ValidationError_
from sskd_tpu_torch.keys import APIKeyManager
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.export import export_student_model, load_quantized_weights
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.weights import jax_params_from_bi_encoder
from sskd_tpu_torch.registry import ModelRegistry
from sskd_tpu_torch.serve.middleware import APIKeyAuth
from sskd_tpu_torch.tokenization import WordPieceTokenizer


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny student (f32 compute) and the port's, on its weights."""
    js = JStudent("tiny-export", config=JConfig.tiny(), compute_dtype=jax.numpy.float32)
    params = jax.tree_util.tree_map(np.asarray, js.params)
    ts = StudentModel("tiny-export", device="cpu", config=BertConfig.tiny(),
                      tokenizer=WordPieceTokenizer(js.tokenizer.vocab), params=params,
                      compute_dtype=None)
    return js, ts, params


@pytest.fixture(scope="module")
def exports(pair, tmp_path_factory):
    js, ts, _ = pair
    root = tmp_path_factory.mktemp("export")
    return (j_export(js, root / "jax"), export_student_model(ts, root / "port"), root)


def test_flax_tree_round_trips(pair):
    _, ts, params = pair
    back = jax_params_from_bi_encoder(ts.module.state_dict(), ts.config)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_npz_equals_the_jax_export_bit_for_bit(exports):
    jrep, trep, root = exports
    jz, tz = np.load(root / "jax" / "weights_int8.npz"), np.load(root / "port" / "weights_int8.npz")
    assert sorted(tz.files) == sorted(jz.files)
    assert any(k.endswith("::int8") for k in tz.files)
    for key in jz.files:
        assert tz[key].dtype == jz[key].dtype, key
        np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)
    for name in ("bytes_f32", "bytes_quantized", "compression_ratio", "validation_passed"):
        assert trep[name] == jrep[name], name
    # the parity check: cosine of each embedding to its dequantized twin
    assert abs(trep["validation_min_cosine"] - jrep["validation_min_cosine"]) <= 1e-5
    assert (root / "port" / "checkpoint" / "weights.pt").exists()
    assert json.loads((root / "port" / "export_report.json").read_text()) == trep


def test_each_package_reads_the_others_file(pair, exports):
    js, ts, params = pair
    _, _, root = exports
    got = j_load(root / "port" / "weights_int8.npz")
    rebuilt = j_dequantize(js.params, got)  # the JAX reader over the port's file
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and np.abs(np.asarray(a) - b).max() <= np.abs(b).max() / 127
    want = j_load(root / "jax" / "weights_int8.npz")
    back = load_quantized_weights(root / "jax" / "weights_int8.npz")
    assert back.keys() == want.keys() == got.keys()
    for key in want:
        for kind in want[key]:
            np.testing.assert_array_equal(back[key][kind], want[key][kind])


def test_unreachable_min_cosine_raises(pair, tmp_path):
    _, ts, _ = pair
    before = {k: v.clone() for k, v in ts.module.state_dict().items()}
    with pytest.raises(ModelError, match="parity"):
        export_student_model(ts, tmp_path, min_cosine=1.5)
    # the student's own weights are back after the check
    for k, v in ts.module.state_dict().items():
        assert np.array_equal(v.numpy(), before[k].numpy()), k


def _strip_times(tree):
    if isinstance(tree, dict):
        return {k: _strip_times(v) for k, v in tree.items()
                if k not in ("registered_at", "promoted_at")}
    return tree


def test_registry_json_equals_jax(tmp_path):
    jax_ckpt = "artifacts/demo/vanilla"  # a JAX checkpoint: params.msgpack
    j, t = JRegistry(tmp_path / "j.json"), ModelRegistry(tmp_path / "t.json", device="cpu")
    for reg in (j, t):
        reg.register("student", jax_ckpt, metrics={"ndcg@10": 0.5})
        reg.register("student", jax_ckpt, metrics={"ndcg@10": 0.6})
        reg.promote("student")
        reg.promote("student", "v2")
        reg.promote("student", "v1")
    assert t.get("student")["weights_hash"] == j.get("student")["weights_hash"]
    assert t.compare("student", "v1", "v2") == j.compare("student", "v1", "v2")
    jtree = json.loads((tmp_path / "j.json").read_text())
    ttree = json.loads((tmp_path / "t.json").read_text())
    assert _strip_times(ttree) == _strip_times(jtree)
    with pytest.raises(ValidationError_):
        t.promote("student", "v2")  # already in production
    with pytest.raises(ModelNotFoundError):
        t.get("student", "v9")


def test_registry_hashes_a_port_checkpoint(pair, tmp_path):
    _, ts, _ = pair
    ts.save(tmp_path / "ckpt")
    card = ModelRegistry(tmp_path / "r.json", device="cpu").register(
        "port", tmp_path / "ckpt", latency_probe=True)
    assert len(card["weights_hash"]) == 12 and card["encode_latency_ms"] > 0


@pytest.mark.parametrize("salt", ["", "pepper"])
def test_keys_verify_across_packages(tmp_path, salt):
    tk = APIKeyManager(tmp_path / "t.json", salt=salt)
    jk = JKeys(tmp_path / "j.json", salt=salt)
    t_key, j_key = tk.generate("svc"), jk.generate("svc")
    # either file opens in the other package with its salt
    assert JKeys(tmp_path / "t.json").active_hashes() == tk.active_hashes()
    assert APIKeyManager(tmp_path / "j.json").active_hashes() == jk.active_hashes()
    for make in (APIKeyAuth, JAuth):
        auth = make(api_key_hashes=tk.active_hashes() + jk.active_hashes(), salt=salt)
        assert auth.verify(t_key) and auth.verify(j_key) and not auth.verify("sk_live_x")
    rotated = tk.rotate("svc")
    assert not APIKeyAuth(api_key_hashes=tk.active_hashes(), salt=salt).verify(t_key)
    assert JAuth(api_key_hashes=tk.active_hashes(), salt=salt).verify(rotated)
    assert json.loads(tk.export_env()) == tk.active_hashes()
    assert tk.list_keys()["svc"]["revoked"] is False and "hash" not in tk.list_keys()["svc"]
    assert (tmp_path / "t.json").stat().st_mode & 0o777 == 0o600
