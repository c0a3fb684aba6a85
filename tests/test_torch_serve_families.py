"""Serving the MoE (mixtral-8x7b) and the VLM (llama-3.2-vision-11b) on
the CPU at their reduced configs, through ``ReplicatedServer`` and the
serve CLI:

* a mid-stream kill under replication ends with the clean run's token
  stream and whole final state (KV rings; the VLM's cross K/V) bitwise,
  one promotion; without a replica it is fatal;
* the port's stream equals the JAX server's on the same weights (carried
  across by ``convert``), both in f32 with the JAX attention's bf16
  probability cast removed (``f32_pv``, F6): the greedy argmax then sees
  logits equal to summation order;
* the replica's state owns its storage before and after the promotion,
  the cross K/V included (F1);
* a ``ModelConfig`` (a depth-cut one) serves as a name does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
from repro.configs import get_arch as jax_arch
from repro_torch.configs import get_arch
from repro_torch.configs.base import FTConfig
from repro_torch.ft import DecodeWorkload, FTSession
from repro_torch.launch.serve import ReplicatedServer, main
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_map
from test_torch_model import f32_pv  # noqa: F401  (a fixture)
from test_torch_serve import _StorageProbe, _storage, _tensors

ARCHS = ["mixtral-8x7b", "llama-3.2-vision-11b"]


def _prompts(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, 400, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_failover_ends_on_the_clean_stream_and_state(arch):
    srv = ReplicatedServer(arch, batch=2, prompt_len=16, device="cpu")
    prompts = _prompts(0)
    clean = srv.generate(prompts, 8)
    clean_state = srv.last_report.final_state["cache"]
    faulty = srv.generate(prompts, 8, kill_at=3)
    faulty_state = srv.last_report.final_state["cache"]
    assert clean.shape == (2, 8)
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1 and srv.failures == 1
    a, b = _tensors(clean_state), _tensors(faulty_state)
    cfg = srv.cfg
    # k, v, pos a self layer; the VLM adds each group's cross k and v
    n = 3 * cfg.n_layers
    if cfg.family == "vlm":
        n += 2 * cfg.n_layers // cfg.cross_attn_every
        assert len(clean_state["cross"]) == 2
    assert len(a) == len(b) == n
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_without_replication_fails(arch):
    srv = ReplicatedServer(arch, batch=2, prompt_len=16, replication=False,
                           device="cpu")
    with pytest.raises(RuntimeError):
        srv.generate(np.zeros((2, 16), dtype=np.int32), 8, kill_at=2)
    assert srv.failures == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_equals_the_jax_servers(arch, f32_pv, monkeypatch):
    """Both servers at the reduced config in f32, the port on the JAX
    server's weights; the JAX server killed mid-stream too."""
    monkeypatch.setattr(jax_serve, "get_arch", lambda name: dataclasses.replace(
        jax_arch(name), dtype="float32"))
    theirs = jax_serve.ReplicatedServer(arch, batch=2, prompt_len=16)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    ours = ReplicatedServer(cfg, batch=2, prompt_len=16, device="cpu")
    ours.model.load_state_dict(params_from_jax(
        jax.device_get(theirs.params), cfg))
    prompts = _prompts(4)
    want = theirs.generate(prompts.copy(), 8, kill_at=3)
    got = ours.generate(prompts, 8, kill_at=3)
    np.testing.assert_array_equal(got, want)
    assert ours.promotions == theirs.promotions == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_state_owns_its_storage(arch):
    """Two ranks: after worker 0 dies rank 0's replica is promoted and
    copied again for rank 1; no state tensor (rings, cross K/V) is ever
    shared between the slices."""
    srv = ReplicatedServer(arch, batch=2, prompt_len=16, device="cpu")
    prompts = _prompts(3)
    session = FTSession(ft=FTConfig(mode="replication"), injector={3: [0]},
                        n_logical_workers=2, workers_per_node=1,
                        allow_restart=False)
    probe = _StorageProbe(srv.workload(prompts), session)
    rep = session.run(probe, 6)
    assert rep.promotions == 1
    assert [t for t, _ in probe.seen] == list(range(6))
    assert all(not shared for _, shared in probe.seen)
    state = rep.final_state["cache"]
    assert len(_storage(state)) == len(_tensors(state))
    np.testing.assert_array_equal(DecodeWorkload.tokens(rep.final_state),
                                  srv.generate(prompts, 6))


def test_vlm_prefill_batch_carries_zero_image_embeddings():
    """The reference's ``_extras``: bf16 zeros [B, n_image_tokens, d] on
    the server's device beside the tokens; MoE batches hold the tokens
    only."""
    vlm = ReplicatedServer("llama-3.2-vision-11b", batch=2, prompt_len=16,
                           device="cpu")
    batch = vlm.workload(_prompts(1)).batch
    emb = batch["image_embeds"]
    assert emb.shape == (2, vlm.cfg.n_image_tokens, vlm.cfg.d_model)
    assert emb.dtype == torch.bfloat16 and not bool(emb.any())
    moe = ReplicatedServer("mixtral-8x7b", batch=2, prompt_len=16,
                           device="cpu")
    assert set(moe.workload(_prompts(1)).batch) == {"tokens"}


def test_a_depth_cut_config_serves():
    """``ReplicatedServer`` takes a ``ModelConfig``: mixtral reduced and
    cut to 2 layers."""
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(), n_layers=2)
    srv = ReplicatedServer(cfg, batch=2, prompt_len=16, device="cpu")
    assert srv.cfg is cfg and len(srv.model.layers) == 2
    toks = srv.generate(_prompts(2), 4, kill_at=1)
    assert toks.shape == (2, 4) and srv.promotions == 1
    shapes = set()
    tree_map(lambda t: shapes.add(t.shape[1])
             if isinstance(t, torch.Tensor) and t.dim() == 4 else None,
             srv.last_report.final_state["cache"])
    assert shapes == {16}                          # the 16-slot ring


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, capsys):
    assert main(["--arch", arch, "--device", "cpu", "--kill-at", "3"]) == 0
    assert "failures=1 promotions=1" in capsys.readouterr().out
