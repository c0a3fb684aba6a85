"""``repro_torch.core.virtual_mesh`` against ``repro.core.virtual_mesh``:
the reference's failure sequences (``tests/test_ft_trainer.py``'s virtual
mesh and executable cache tests) and drawn ones, each run on both
classes, every event and the whole map after each step equal (slots,
spares, dead, shape; exact: integer bookkeeping). Also the current slots
as a ``DeviceMesh`` over a one-process world."""
import pytest

from _hypothesis_compat import given, settings, st
from repro.core.virtual_mesh import ExecutableCache as JCache
from repro.core.virtual_mesh import VirtualMesh as JMesh
from repro_torch.core.virtual_mesh import ExecutableCache, VirtualMesh


def _state(vm):
    return (vm.shape, vm.axes, list(vm.slots), list(vm.spares),
            sorted(vm.dead), [vars(e) for e in vm.history])


def _both(shape, axes=("data", "model"), n_spares=0):
    return (JMesh(shape, axes, n_spares=n_spares),
            VirtualMesh(shape, axes, n_spares=n_spares))


def _fail(pair, devices):
    ref, port = pair
    want, got = ref.fail_devices(devices), port.fail_devices(devices)
    assert vars(got) == vars(want)
    assert _state(port) == _state(ref)
    return got


def test_spare_fill():
    pair = _both((2, 4), n_spares=2)
    ev = _fail(pair, [pair[0].slots[3]])
    assert ev.kind == "spare_fill" and len(set(pair[1].slots)) == 8


def test_shrink_dp_when_no_spares_then_spare_fill():
    pair = _both((4, 2))
    ev = _fail(pair, [pair[0].slots[0]])
    assert ev.kind == "shrink_dp" and ev.new_dp == 3
    assert pair[1].shape == (3, 2) and len(pair[1].spares) == 1
    assert _fail(pair, [pair[0].slots[0]]).kind == "spare_fill"


def test_fatal_when_everything_dies():
    pair = _both((1, 2))
    assert _fail(pair, list(pair[0].slots)).kind == "fatal"


def test_failure_of_a_spare_or_an_unknown_device():
    pair = _both((2, 2), n_spares=1)
    assert _fail(pair, [4]).kind == "spare_fill"       # the spare dies
    assert _fail(pair, [99]).kind == "spare_fill"      # not in the mesh
    assert _fail(pair, [0, 1]).kind == "shrink_dp"


def test_queries_equal():
    pair = _both((2, 4), n_spares=1)
    _fail(pair, [5])
    ref, port = pair
    for s in range(ref.n_slots):
        assert port.dp_index_of_slot(s) == ref.dp_index_of_slot(s)
        assert port.slot_of(port.slots[s]) == ref.slot_of(ref.slots[s])
    assert port.device_array().tolist() == ref.device_array().tolist()
    assert port.ranks().tolist() == ref.device_array().tolist()


def test_executable_cache_hits():
    vm = VirtualMesh((4, 2), ("data", "model"))
    cache, ref = ExecutableCache(), JCache()
    calls = []
    for c in (cache, ref):
        exe1 = c.get_or_compile(vm, "train", lambda: calls.append(1) or "A")
        exe2 = c.get_or_compile(vm, "train", lambda: calls.append(1) or "B")
        assert exe1 == exe2 == "A"
    assert (cache.hits, cache.misses) == (ref.hits, ref.misses) == (1, 1)
    cache.precompile([(3, 2), (2, 2)], "train", lambda shape: shape)
    ref.precompile([(3, 2), (2, 2)], "train", lambda shape: shape)
    assert cache._cache.keys() == ref._cache.keys()


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4), st.integers(1, 3), st.integers(0, 3),
       st.lists(st.lists(st.integers(0, 20), min_size=1, max_size=3),
                min_size=1, max_size=6))
def test_drawn_failure_sequences_equal(dp, mp, spares, waves):
    """Meshes of dp x mp slots and some spares, waves of failures among
    21 device ids (some in the mesh, some spares, some unknown or already
    dead; each id once a wave): the same events and maps on both sides,
    until a fatal event."""
    pair = _both((dp, mp), n_spares=spares)
    for wave in waves:
        if _fail(pair, list(dict.fromkeys(wave))).kind == "fatal":
            break


def test_a_device_twice_in_one_wave_raises_on_both():
    """The reference spare-fills each listed slot in turn, so a device
    listed twice is looked up after it left the map: both raise."""
    for cls in (JMesh, VirtualMesh):
        vm = cls((1, 1), ("data", "model"), n_spares=2)
        with pytest.raises(ValueError):
            vm.fail_devices([0, 0])


def test_device_mesh_over_the_slots():
    """``device_mesh`` names the logical axes over the slots' ranks (a
    one-process world of 4 fake ranks, ended afterwards)."""
    from repro_torch.launch.mesh import end_world, fake_world
    vm = VirtualMesh((2, 2), ("data", "model"), n_spares=0)
    fake_world(4)
    try:
        mesh = vm.device_mesh("cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.tolist() == [[0, 1], [2, 3]]
    finally:
        end_world()
    with pytest.raises(ValueError):
        VirtualMesh((2, 2), ("data", "model"), devices=[0, 1, 2])
