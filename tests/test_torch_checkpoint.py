"""The port's on-disk Checkpointer against the JAX package's: a train
state of the reduced qwen3-8b saved by one side is restored by the other
bitwise, and both write the same manifest (keys, shapes, dtypes, bands).
The state's values are drawn by numpy: bf16 params, f32 moments, an int32
step, as the reference's train state holds them."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_arch as jget_arch
from repro.launch.step_fns import make_model as jmake_model
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.models import convert
from repro_torch.optim.adamw import AdamWState

CFG = get_arch("qwen3-8b").reduced()


@pytest.fixture(scope="module")
def jax_state():
    jcfg = jget_arch("qwen3-8b").reduced()
    run = JRunConfig(model=jcfg, shape=JShapeConfig("t", seq_len=16,
                                                   global_batch=2,
                                                   kind="train"))
    params = jmake_model(run).init(jax.random.key(3))
    rng = np.random.default_rng(0)

    def moment(p):
        return jnp.asarray(rng.normal(size=p.shape).astype(np.float32))
    return {"params": params,
            "opt": JAdamWState(step=jnp.asarray(7, jnp.int32),
                               m=jax.tree.map(moment, params),
                               v=jax.tree.map(moment, params))}


def _port_state(jstate):
    host = jax.device_get(jstate)
    opt = host["opt"]
    return {"params": convert.params_from_jax(host["params"], CFG, "cpu"),
            "opt": AdamWState(step=torch.tensor(int(opt.step),
                                                dtype=torch.int32),
                              m=convert.params_from_jax(opt.m, CFG, "cpu"),
                              v=convert.params_from_jax(opt.v, CFG, "cpu"))}


def _assert_port_equal(a, b):
    assert a["params"].keys() == b["params"].keys()
    for tree in ("params",):
        for k in a[tree]:
            assert a[tree][k].dtype == b[tree][k].dtype
            assert torch.equal(a[tree][k], b[tree][k]), k
    assert torch.equal(a["opt"].step, b["opt"].step)
    for k in a["params"]:
        assert torch.equal(a["opt"].m[k], b["opt"].m[k]), k
        assert torch.equal(a["opt"].v[k], b["opt"].v[k]), k


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def test_reference_save_restored_by_the_port(jax_state, tmp_path):
    JCheckpointer(str(tmp_path)).save(7, jax_state)
    like = _port_state(jax_state)
    zeroed = {"params": {k: torch.zeros_like(v)
                         for k, v in like["params"].items()},
              "opt": AdamWState(torch.zeros((), dtype=torch.int32),
                                {k: torch.zeros_like(v)
                                 for k, v in like["opt"].m.items()},
                                {k: torch.zeros_like(v)
                                 for k, v in like["opt"].v.items()})}
    got, step, extra = Checkpointer(str(tmp_path)).restore(zeroed)
    assert step == 7 and extra == {}
    _assert_port_equal(got, like)


def test_port_save_restored_by_the_reference(jax_state, tmp_path):
    Checkpointer(str(tmp_path)).save(7, _port_state(jax_state),
                                     extra={"mode": "combined"})
    like = jax.tree.map(jnp.zeros_like, jax_state)
    got, step, extra = JCheckpointer(str(tmp_path)).restore(like)
    assert step == 7 and extra == {"mode": "combined"}
    want = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    have = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in want] == [p for p, _ in have]
    for (path, a), (_, b) in zip(want, have):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("n_bands", [1, 4, 6])
def test_manifests_are_the_reference_manifest(jax_state, tmp_path, n_bands):
    JCheckpointer(str(tmp_path / "ref"), n_bands).save(7, jax_state)
    Checkpointer(str(tmp_path / "port"), n_bands).save(
        7, _port_state(jax_state))
    mans = [json.loads((tmp_path / side / "step_00000007" /
                        "manifest.json").read_text())
            for side in ("ref", "port")]
    assert mans[0] == mans[1]
    assert "opt/.step" in mans[1]["leaves"]
    assert mans[1]["leaves"]["params/layers/attn/wq"]["shape"][0] == \
        CFG.n_layers
    assert mans[1]["leaves"]["params/embed/embed"]["dtype"] == "bfloat16"
    for i in range(n_bands):
        files = [sorted(np.load(tmp_path / side / "step_00000007" /
                                f"band_{i}.npz").files)
                 for side in ("ref", "port")]
        assert files[0] == files[1]


def test_latest_pointer_bands_and_gc(jax_state, tmp_path):
    ck = Checkpointer(str(tmp_path), n_bands=4)
    state = _port_state(jax_state)
    ck.save(0, state, baseline=True)
    assert ck.latest_tag() is None and ck.exists("baseline")
    for step in (3, 6, 9):
        ck.save(step, state)
    assert ck.latest_step() == 9
    assert ck.last_bytes == sum(
        t.numel() * t.element_size()
        for tree in (state["params"], state["opt"].m, state["opt"].v)
        for t in tree.values()) + 4
    ck.gc(keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "baseline", "step_00000006", "step_00000009"]
    got, step, _ = ck.restore(state)
    assert step == 9
    _assert_port_equal(got, state)
    for k, t in got["params"].items():          # storage of its own
        assert t.data_ptr() != state["params"][k].data_ptr()
    # every band named: the same state
    _assert_port_equal(ck.restore(state, bands=[3, 1, 0, 2])[0], state)


def test_elastic_restore_reads_the_bands_asked_for(tmp_path):
    """A reader of some bands gets those bands' rows of each banded leaf,
    in band order; band 0 holds the unbanded leaves."""
    tree = {"a": torch.arange(30.0).reshape(10, 3),
            "b": torch.arange(3, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), n_bands=4)        # 3 rows a band
    ck.save(1, tree)
    like = {"a": torch.zeros(6, 3), "b": torch.zeros(3, dtype=torch.int32)}
    got, step, _ = ck.restore(like, bands=[0, 2])
    assert torch.equal(got["a"], torch.cat([tree["a"][0:3], tree["a"][6:9]]))
    assert torch.equal(got["b"], tree["b"])
    with pytest.raises(FileNotFoundError, match="b"):
        ck.restore({"a": torch.zeros(1, 3),
                    "b": torch.zeros(3, dtype=torch.int32)}, bands=[3])


def test_params_to_jax_inverts_params_from_jax(jax_state):
    host = jax.device_get(jax_state["params"])
    back = convert.params_to_jax(convert.params_from_jax(host, CFG, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, a in want:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, _bits(a))


def test_a_restore_checks_dtype_and_shape(jax_state, tmp_path):
    state = _port_state(jax_state)
    Checkpointer(str(tmp_path)).save(1, state)
    wrong = dict(state, params={k: v.float() for k, v in
                                state["params"].items()})
    with pytest.raises(ValueError, match="bfloat16"):
        Checkpointer(str(tmp_path)).restore(wrong)


def test_train_state_to_jax_is_the_reference_tree(jax_state):
    """The whole-state mapping: params, step, m and v under the
    reference's nesting, each leaf bitwise."""
    got = convert.train_state_to_jax(_port_state(jax_state))
    want = jax.device_get(jax_state)
    step, m, v = got["opt"]
    assert step.dtype == np.int32 and int(step) == int(want["opt"].step)
    for mine, ref in ((got["params"], want["params"]), (m, want["opt"].m),
                      (v, want["opt"].v)):
        for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
            node = mine
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, _bits(a))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_scalar_leaves_round_trip(dtype, tmp_path):
    """A stack of 0-d blocks (the VLM's ``cross.<g>.gate``, whisper's
    ``dec_layers.<i>.xattn.gate``) saves as one [n] leaf and restores
    bitwise through either package (before the fix the port's save took a
    numpy scalar for a view of the block and raised)."""
    vals = torch.tensor([0.5, -1.25, 3.0, 7.5]).to(dtype)
    state = {"params": {f"dec_layers.{i}.xattn.gate": vals[i].clone()
                        for i in range(4)} | {"ln_f.scale": vals.clone()}}
    ck = Checkpointer(str(tmp_path / "port"), n_bands=2)
    ck.save(3, state)
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()}}
    got, step, _ = ck.restore(like)
    assert step == 3
    for k, v in state["params"].items():
        assert got["params"][k].shape == v.shape and torch.equal(
            got["params"][k], v), k
    jlike = {"params": {"dec_layers": {"xattn": {"gate": np.zeros(
        4, np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16)}},
        "ln_f": {"scale": np.zeros(
            4, np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16)}}}
    jgot, jstep, _ = JCheckpointer(str(tmp_path / "port")).restore(jlike)
    assert jstep == 3
    np.testing.assert_array_equal(
        _bits(jgot["params"]["dec_layers"]["xattn"]["gate"]),
        _bits(convert.to_numpy(vals)))
