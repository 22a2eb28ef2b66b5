"""The port's sharding rules (``launch/sharding.py``) against the JAX
package's (``repro.launch.sharding``), leaf by leaf at every registered
arch's full width, and ``configs/base.py``'s input specs and active
parameter counts against ``repro.configs``.

The reference stacks each super-block's layers on a leading axis; the
port keeps a leaf a layer.  So for every port leaf ``layers/i/...`` of
shape s the reference's leaf is ``blocks/(i % period)/...`` of shape
(n_blocks, *s), and the port's rule must equal the reference's rule for
(1, *s) under that path with the leading entry dropped.  The two sets of
per-layer (name, shape) must agree first.  The port's shapes come from its
initialiser under ``FakeTensorMode`` (nothing allocated), the reference's
from ``jax.eval_shape``.  Meshes are stand-ins with the production shapes,
16 x 16 and 2 x 16 x 16 (the rules read only names and sizes);
``to_placements`` runs on a (2, 2) and a (1, 2, 2) mesh over a fake group
of 4 ranks in a child process (``tests/_torch_launch_worker.py``)."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

import _torch_launch_worker as worker  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import decoder as jdecoder  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, input_specs  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

ARCHS = sorted(list_configs())
MESHES = {"16x16": (("data", "model"), (16, 16)), "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
MAX_SEQ = 4096


class _JaxMesh:
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def port_mesh(name):
    names, sizes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=names, shape=sizes)


def jax_mesh(name):
    return _JaxMesh(*MESHES[name])


def norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple as its axis name (the
    reference's PartitionSpec prints ("data",) as "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _jax_path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


@functools.cache
def port_leaves(arch: str) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = decoder.init_params(get_config(arch), device="cpu", max_seq=MAX_SEQ)
        return {k.replace(".", "/"): tuple(v.shape) for k, v in decoder.flat_params(params).items()}


@functools.cache
def ref_leaves(arch: str) -> dict:
    """The reference's leaves unstacked: port path -> (reference path, shape)."""
    cfg = jget_config(arch)
    tree = jax.eval_shape(lambda: jdecoder.init_params(cfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ))
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = _jax_path(kp)
        head, _, rest = path.partition("/")
        if head in ("blocks", "enc_blocks"):
            j, _, tail = rest.partition("/")
            period = len(tree[head])
            for b in range(leaf.shape[0]):
                layer = "layers" if head == "blocks" else "enc_layers"
                out[f"{layer}/{b * period + int(j)}/{tail}"] = (path, tuple(leaf.shape[1:]))
        else:
            out[path] = (path, tuple(leaf.shape))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_per_layer_leaves_match_the_reference(arch):
    assert port_leaves(arch) == {k: s for k, (_, s) in ref_leaves(arch).items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("embed_mode", [None, "vocab_only"])
@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_equals_the_reference(arch, mode, embed_mode, mesh):
    pm, jm = port_mesh(mesh), jax_mesh(mesh)
    for path, shape in port_leaves(arch).items():
        ref_path, _ = ref_leaves(arch)[path]
        got = sharding.param_pspec(path, shape, pm, mode, embed_mode)
        if ref_path == path:  # not stacked
            want = tuple(jsharding.param_pspec(ref_path, _Leaf(shape), jm, mode, embed_mode))
        else:
            want = tuple(jsharding.param_pspec(ref_path, _Leaf((1, *shape)), jm, mode, embed_mode))
            assert want[0] is None, (path, want)
            want = want[1:]
        assert norm(got) == norm(want), (path, shape, got, want)


def _ref_cache(arch, shape_name, cross_cache):
    """The reference's decode cache at the dry-run's plan (the port's plan,
    which ``tests/test_torch_dryrun.py`` holds to the reference's: importing
    ``repro.launch.dryrun`` here would set its 512-device XLA_FLAGS in this
    process)."""
    cfg = jget_config(arch)
    shape = JSHAPES[shape_name]
    length, rolling = dryrun.decode_cache_plan(get_config(arch), INPUT_SHAPES[shape_name])
    tree = jax.eval_shape(lambda: jdecoder.init_cache(cfg, shape.global_batch, length, rolling, cross_cache=cross_cache))
    return cfg, tree


# the dry-run skips an encoder-decoder at long_500k (skip_reason)
CACHE_PAIRS = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
               if not (s == "long_500k" and get_config(a).is_encoder_decoder)]


@pytest.mark.parametrize("batch_only", [False, True])
@pytest.mark.parametrize("arch,shape_name", CACHE_PAIRS)
def test_cache_pspec_equals_the_reference(arch, shape_name, batch_only):
    """Every layer's decode cache (cross K/V planes too for an
    encoder-decoder) on both meshes: the port's rule equals the
    reference's for the stacked block leaf with its leading None dropped."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cross = get_config(arch).is_encoder_decoder
    jcfg, tree = _ref_cache(arch, shape_name, cross)
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    length, rolling = dryrun.decode_cache_plan(cfg, shape)
    with FakeTensorMode():
        cache = decoder.init_cache(cfg, shape.global_batch, length, rolling, device="cpu", cross_cache=cross)
    period = len(tree)
    for mesh in MESHES:
        pm, jm = port_mesh(mesh), jax_mesh(mesh)
        for i, layer in enumerate(cache):
            ref = tree[i % period]
            assert sorted(layer) == sorted(ref), (i, sorted(layer), sorted(ref))
            for k, t in layer.items():
                assert (1, *t.shape) == (1, *ref[k].shape[1:]), (i, k)
                want = tuple(jsharding.cache_pspec(k, _Leaf((1, *t.shape)), jm, jcfg, batch_only))
                assert want[0] is None
                assert norm(sharding.cache_pspec(k, t.shape, pm, batch_only)) == norm(want[1:]), (mesh, i, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 16, 32, 128, 256, 512])
def test_batch_spec_and_scheduler_pspec_equal_the_reference(mesh, batch):
    pm, jm = port_mesh(mesh), jax_mesh(mesh)
    for extra in (0, 1, 2):
        assert norm(sharding.batch_spec(pm, batch, extra)) == norm(jsharding.batch_spec(jm, batch, extra))
    assert norm(sharding.scheduler_pspec(pm)) == norm(jsharding.scheduler_pspec(jm))


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape_name):
    got = input_specs(get_config(arch), INPUT_SHAPES[shape_name])
    want = jinput_specs(jget_config(arch), JSHAPES[shape_name])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == jnp.dtype(w.dtype).name, k
    assert INPUT_SHAPES[shape_name].__dict__ == JSHAPES[shape_name].__dict__


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_equals_the_reference(arch):
    assert get_config(arch).active_param_count() == jget_config(arch).active_param_count()


S0, S1, S2, R = ("Shard", 0), ("Shard", 1), ("Shard", 2), ("Replicate", None)
PLACEMENT_CASES = [
    ((2, 2), ("data", None), [S0, R]),
    ((2, 2), (None, "model"), [R, S1]),
    ((2, 2), ("model", "data"), [S1, S0]),
    ((2, 2), (("data",), None, None), [S0, R]),
    ((2, 2), (None, None), [R, R]),
    ((2, 2), (), [R, R]),
    ((1, 2, 2), (("pod", "data"), None, "model"), [S0, S0, S2]),
    ((1, 2, 2), (None, "data"), [R, S1, R]),
    ((2, 2), ("data", "data"), "error"),  # one axis twice
    ((2, 2), ("pod", None), "error"),  # not an axis of the mesh
]


def test_to_placements_on_a_fake_mesh(tmp_path):
    cases = [dict(case="placements", mesh=m, spec=s) for m, s, _ in PLACEMENT_CASES]
    got = worker.run_fake(cases, tmp_path)
    for (mesh, spec, want), g in zip(PLACEMENT_CASES, got):
        if want == "error":
            assert "error" in g and g["error"].startswith("ValueError"), (spec, g)
        else:
            assert g == want, (mesh, spec, g)
