"""The port's token stream against the JAX package's: the batches are
the contract (a replica or a restarted job regenerates exactly the batch it
needs), so every comparison here is bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import ShardedSource as JShardedSource
from repro.data import TokenSource as JTokenSource
from repro_torch.data import DataConfig, ShardedSource, TokenSource
from repro_torch.data import pipeline

SHAPES = [(4, 32, 512), (3, 17, 151936)]        # (B, S, V)


def test_the_partitionable_flag_is_on():
    """The numpy threefry follows JAX's partitionable counter layout."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("step", [0, 1, 5, 123456])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_are_the_reference_bits(seed, step, shape):
    b, s, v = shape
    want = JTokenSource(JDataConfig(v, s, b, seed)).host_batch_at(step)
    got = TokenSource(DataConfig(v, s, b, seed)).batch_at(step)
    assert set(got) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("worker", [0, 1, 3])
def test_sharded_rows_are_the_reference_rows(worker):
    cfg = (512, 16, 8, 3)
    want = JShardedSource(JTokenSource(JDataConfig(*cfg)), worker,
                          4).batch_at(9)
    got = ShardedSource(TokenSource(DataConfig(*cfg)), worker, 4).batch_at(9)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,data", [(0, 0), (7, 3), (-3, 99), (2 ** 31 - 1, 2 ** 32 - 1)])
def test_fold_in_and_bits_are_jax_threefry(seed, data):
    """Each piece on its own: the key of a seed, ``fold_in``, the
    partitionable 32-bit ``random_bits`` and ``uniform``."""
    jkey = jax.random.key(seed)
    assert tuple(pipeline.seed_key(seed)) == tuple(
        np.asarray(jax.random.key_data(jkey)))
    jfold = jax.random.fold_in(jkey, data)
    fold = pipeline.fold_in(pipeline.seed_key(seed), data)
    assert tuple(fold) == tuple(np.asarray(jax.random.key_data(jfold)))
    np.testing.assert_array_equal(
        pipeline.random_bits32(fold, (5, 7)),
        np.asarray(jax.random.bits(jfold, (5, 7), jnp.uint32)))
    np.testing.assert_array_equal(
        pipeline.uniform(fold, (3, 11)).view(np.uint32),
        np.asarray(jax.random.uniform(jfold, (3, 11))).view(np.uint32))


def test_a_batch_depends_on_its_step_only():
    src = TokenSource(DataConfig(512, 16, 4, 1))
    a = src.batch_at(3)
    src.batch_at(100)
    np.testing.assert_array_equal(src.batch_at(3)["tokens"], a["tokens"])
    assert not np.array_equal(src.batch_at(4)["tokens"], a["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
