"""The leaf-table FedAvg reduce against the JAX package's FedAvg.

``fedavg_reduce_leaves`` reads the client leaves in place: one or two row
groups of stacked (K, ...) leaves with (K,) weights, each leaf filling its
columns of the (P,) output, the groups added in order.  On the CPU its
plain version (``kernels.ref.fedavg_reduce_leaves_ref``) carries the port's
``_compact_mean`` (two groups: the k-slab and the old-carrier stack) and
``_masked_mean`` (one group).  Both are held to the reference's
``repro.core.simulator._compact_mean`` and ``_masked_mean`` on the same
numpy-seeded inputs, through the reference's plain per-leaf sums and
through its ``fedavg_reduce`` Pallas kernel in interpret mode, over the
reduced CNN's 18 leaves and a ragged layout (leaf column counts 1, 3, 10,
37 and 4096, so that rows of 4, 40 and 148 bytes are not 16-byte aligned),
and tables of 33 and 70 leaves, more than one launch takes.
Tolerances: fp32 1e-6 (the two sides sum the same products in another
order); bf16 0.05 (the reference sums bf16 products where the port
accumulates in fp32; tests/test_kernels.py's bf16 tolerance).  An all-zero
mask keeps the fallback; an Inf in a zero-weight row (an old-carrier row
that does not upload, a padding lane of the slab) gives NaN in exactly its
column, as 0·Inf does in the reference.  The kernel itself runs on the card
(tests marked ``cuda``, which need no JAX: the card's machine has none, so
the JAX package is imported inside the helpers that call it); here its
wrapper is checked to raise on every table it does not take.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_cnn  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fedavg_reduce import fedavg_reduce as fedavg_kernel  # noqa: E402
from repro_torch.kernels.fedavg_reduce import fedavg_reduce_leaves as leaves_kernel  # noqa: E402
from repro_torch.models.cnn import init_params  # noqa: E402

N, CAP = 12, 4  # fleet and slab widths
TOL = {"float32": 1e-6, "bfloat16": 0.05}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RAGGED = {"a": (1,), "b": (3,), "c": (10,), "d": (37,), "e": (64, 64)}  # 1, 3, 10, 37, 4096 columns


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def many_leaves(n):
    """``n`` leaves cycling through ragged column counts (1, 3, 10, 37, 64,
    8): more than one launch's table of 32, and runs whose output slices
    start off a 16-byte boundary."""
    shapes = [(1,), (3,), (10,), (37,), (4, 16), (8,)]
    return {f"l{j:03d}": shapes[j % len(shapes)] for j in range(n)}


def layout(name):
    if name.startswith("many"):
        return many_leaves(int(name[4:]))
    if name == "cnn":
        params = init_params(reduced_cnn(), torch.Generator().manual_seed(0), torch.device("cpu"))
        return {k: tuple(v.shape) for k, v in params.items()}
    return RAGGED


def stacked(rng, shapes, k, dtype):
    """{name: (k, *shape)} float32 numpy normals, rounded to ``dtype``."""
    return {n: torch.from_numpy(rng.standard_normal((k, *s), dtype=np.float32)).to(TORCH_DTYPES[dtype]).float().numpy()
            for n, s in shapes.items()}


def to_jax(tree, dtype):
    import jax.numpy as jnp

    return {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in tree.items()}


def to_torch(tree, dtype):
    return {k: torch.from_numpy(np.array(v)).to(TORCH_DTYPES[dtype]) for k, v in tree.items()}


def as_numpy(tree):
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32) for k, v in tree.items()}


def compact_case(seed, name, dtype, slab_mask=None, old_mask=None):
    rng = np.random.default_rng(seed)
    shapes = layout(name)
    slab, old, fb = stacked(rng, shapes, CAP, dtype), stacked(rng, shapes, N, dtype), stacked(rng, shapes, 1, dtype)
    fb = {k: v[0] for k, v in fb.items()}
    slab_mask = np.array([1, 0, 1, 0], bool) if slab_mask is None else slab_mask
    old_mask = (np.arange(N) % 5 == 2) if old_mask is None else old_mask
    return slab, slab_mask, old, old_mask, fb


def jax_compact(slab, slab_mask, old, old_mask, fb, dtype, path):
    import jax.numpy as jnp
    from repro.core import simulator as jsim

    return jsim._compact_mean(to_jax(slab, dtype), jnp.asarray(slab_mask), to_jax(old, dtype), jnp.asarray(old_mask),
                              to_jax(fb, dtype), use_kernel=path == "pallas")


def torch_compact(slab, slab_mask, old, old_mask, fb, dtype):
    return tsim._compact_mean(to_torch(slab, dtype), torch.from_numpy(slab_mask), to_torch(old, dtype),
                              torch.from_numpy(old_mask), to_torch(fb, dtype))


def jax_masked(stack, mask, fb, dtype, path):
    import jax.numpy as jnp
    from repro.core import simulator as jsim

    fn = jsim._masked_mean_kernel if path == "pallas" else jsim._masked_mean
    return fn(to_jax(stack, dtype), jnp.asarray(mask), to_jax(fb, dtype))


def assert_trees_close(got, want, tol):
    got, want = as_numpy(got), as_numpy(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("path", ["plain", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["cnn", "ragged"])
def test_compact_mean_two_groups_matches_reference(name, dtype, path):
    case = compact_case(1, name, dtype)
    got = torch_compact(*case, dtype)
    assert all(v.dtype == TORCH_DTYPES[dtype] for v in got.values())
    assert_trees_close(got, jax_compact(*case, dtype, path), TOL[dtype])


@pytest.mark.parametrize("path", ["plain", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["cnn", "ragged"])
def test_masked_mean_one_group_matches_reference(name, dtype, path):
    rng = np.random.default_rng(2)
    shapes = layout(name)
    stack, fb = stacked(rng, shapes, N, dtype), {k: v[0] for k, v in stacked(rng, shapes, 1, dtype).items()}
    mask = np.arange(N) % 3 == 1
    got = tsim._masked_mean(to_torch(stack, dtype), torch.from_numpy(mask), to_torch(fb, dtype))
    assert_trees_close(got, jax_masked(stack, mask, fb, dtype, path), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", ["many33", "many70"])
def test_more_than_32_leaves_match_reference(name, groups, dtype):
    """Tables of 33 and 70 leaves (an LM's params run to hundreds: qwen1.5-0.5b
    has 290) through the plain version, one group (``_masked_mean``) and two
    (``_compact_mean``), against the JAX package's plain FedAvg."""
    if groups == 2:
        case = compact_case(9, name, dtype)
        got, want = torch_compact(*case, dtype), jax_compact(*case, dtype, "plain")
    else:
        rng = np.random.default_rng(10)
        shapes = layout(name)
        stack, fb = stacked(rng, shapes, N, dtype), {k: v[0] for k, v in stacked(rng, shapes, 1, dtype).items()}
        mask = np.arange(N) % 4 == 1
        got = tsim._masked_mean(to_torch(stack, dtype), torch.from_numpy(mask), to_torch(fb, dtype))
        want = jax_masked(stack, mask, fb, dtype, "plain")
    assert len(got) == int(name[4:]) and all(v.dtype == TORCH_DTYPES[dtype] for v in got.values())
    assert_trees_close(got, want, TOL[dtype])


@pytest.mark.parametrize("name", ["cnn", "ragged"])
def test_all_zero_masks_keep_the_fallback(name):
    slab, _, old, _, fb = compact_case(3, name, "float32")
    none_s, none_o = np.zeros(CAP, bool), np.zeros(N, bool)
    for got, want in (
        (torch_compact(slab, none_s, old, none_o, fb, "float32"),
         jax_compact(slab, none_s, old, none_o, fb, "float32", "plain")),
        (tsim._masked_mean(to_torch(old, "float32"), torch.from_numpy(none_o), to_torch(fb, "float32")),
         jax_masked(old, none_o, fb, "float32", "plain")),
    ):
        assert_trees_close(got, want, 0.0)
        assert_trees_close(got, fb, 0.0)


@pytest.mark.parametrize("where", ["old_row_not_uploading", "slab_padding_lane"])
@pytest.mark.parametrize("path", ["plain", "pallas"])
def test_inf_under_zero_weight_gives_nan_in_exactly_its_column(where, path):
    slab, slab_mask, old, old_mask, fb = compact_case(4, "ragged", "float32")
    if where == "old_row_not_uploading":
        assert not old_mask[0]
        old["d"][0, 5] = np.inf
    else:
        assert not slab_mask[1]
        slab["d"][1, 5] = np.inf
    got = as_numpy(torch_compact(slab, slab_mask, old, old_mask, fb, "float32"))
    want = as_numpy(jax_compact(slab, slab_mask, old, old_mask, fb, "float32", path))
    for k in want:
        expect = np.zeros(want[k].shape, bool)
        if k == "d":
            expect[5] = True
        np.testing.assert_array_equal(np.isnan(want[k]), expect, err_msg=f"reference {k}")
        np.testing.assert_array_equal(np.isnan(got[k]), expect, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL["float32"], err_msg=k)


def test_leaf_form_equals_the_flattened_reduces():
    """Two groups read in place equal the parent's route: each group
    flattened, reduced, then added (bit for bit on the CPU)."""
    slab, slab_mask, old, old_mask, _ = compact_case(5, "cnn", "float32")
    names = sorted(slab)
    groups = [([torch.from_numpy(slab[k]) for k in names], torch.from_numpy(slab_mask).float()),
              ([torch.from_numpy(old[k]) for k in names], torch.from_numpy(old_mask).float())]
    flat = [torch.cat([t.reshape(t.shape[0], -1) for t in leaves], 1) for leaves, _ in groups]
    want = ref.fedavg_reduce_ref(flat[0], groups[0][1]) + ref.fedavg_reduce_ref(flat[1], groups[1][1])
    got = ops.fedavg_reduce_leaves(groups)
    assert got.shape == (sum(math.prod(s) for s in layout("cnn").values()),)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def bad_tables():
    f, b = torch.zeros(3, 5), torch.zeros(3, 5, dtype=torch.bfloat16)
    w = torch.zeros(3)
    return {
        "no_groups": ([], ValueError),
        "three_groups": ([([f], w)] * 3, ValueError),
        "no_leaves": ([([], w)], ValueError),
        # more than a launch's 32 leaves is a table the wrapper takes in runs;
        # a bad 33rd leaf must still refuse the table before any launch
        "33_leaves": ([([f] * 32 + [b], w)], TypeError),
        "float16": ([([f.half()], w)], TypeError),
        "mixed_dtypes": ([([f, b], w)], TypeError),
        "weights_dtype": ([([f], w.double())], ValueError),
        "weights_len": ([([f], torch.zeros(4))], ValueError),
        "leaf_count_differs": ([([f, f], w), ([f], w)], ValueError),
        "shape_differs": ([([f], w), ([torch.zeros(3, 6)], w)], ValueError),
        "noncontiguous": ([([torch.zeros(5, 3).t()], w)], ValueError),
        "scalar_leaf": ([([torch.zeros(())], torch.zeros(1))], ValueError),
    }


@pytest.mark.parametrize("case", sorted(bad_tables()))
def test_leaves_kernel_rejects_bad_tables(case):
    groups, exc = bad_tables()[case]
    before = (fedavg_kernel.launches, fedavg_kernel.row_groups)
    with pytest.raises(exc):
        leaves_kernel(groups)
    assert (fedavg_kernel.launches, fedavg_kernel.row_groups) == before


def test_leaves_kernel_raises_on_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        leaves_kernel([([torch.zeros(2, 5)], torch.zeros(2))])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["cnn", "ragged"])
def test_leaves_kernel_on_gpu(name, dtype, groups, cuda_device):
    slab, slab_mask, old, old_mask, _ = compact_case(6, name, dtype)
    old["d" if name == "ragged" else "fc2_b"][0, 3] = np.inf  # a zero-weight old row
    names = sorted(slab)
    table = [([torch.from_numpy(g[k]).to(TORCH_DTYPES[dtype]).to(cuda_device) for k in names],
              torch.from_numpy(m).float().to(cuda_device)) for g, m in ((slab, slab_mask), (old, old_mask))][:groups]
    before = (fedavg_kernel.launches, fedavg_kernel.row_groups)
    got = leaves_kernel(table)
    torch.cuda.synchronize()
    assert (fedavg_kernel.launches, fedavg_kernel.row_groups) == (before[0] + 1, before[1] + groups)
    want = ref.fedavg_reduce_leaves_ref(table)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(want).any().item() == (groups == 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn", "ragged"])
def test_compact_mean_on_gpu_matches_cpu(name, cuda_device):
    case = compact_case(7, name, "float32")
    cpu = torch_compact(*case, "float32")
    slab, slab_mask, old, old_mask, fb = case
    before = (fedavg_kernel.launches, fedavg_kernel.row_groups)
    gpu = tsim._compact_mean(*(
        {k: v.to(cuda_device) for k, v in to_torch(t, "float32").items()} if isinstance(t, dict)
        else torch.from_numpy(t).to(cuda_device) for t in (slab, slab_mask, old, old_mask, fb)
    ))
    assert (fedavg_kernel.launches, fedavg_kernel.row_groups) == (before[0] + 1, before[1] + 2)
    for k in cpu:
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["many33", "many70"])
def test_more_than_32_leaves_launch_in_runs_of_32(name, dtype, cuda_device):
    """ceil(L / 32) launches for L leaves, each writing its slice of the
    one output (runs that start off a 16-byte boundary through a buffer of
    their own), against the plain version."""
    slab, slab_mask, old, old_mask, _ = compact_case(11, name, dtype)
    names = sorted(slab)
    table = [([torch.from_numpy(g[k]).to(TORCH_DTYPES[dtype]).to(cuda_device) for k in names],
              torch.from_numpy(m).float().to(cuda_device)) for g, m in ((slab, slab_mask), (old, old_mask))]
    before = (fedavg_kernel.launches, fedavg_kernel.row_groups)
    got = leaves_kernel(table)
    torch.cuda.synchronize()
    runs = math.ceil(len(names) / 32)
    assert (fedavg_kernel.launches, fedavg_kernel.row_groups) == (before[0] + runs, before[1] + 2 * runs)
    torch.testing.assert_close(got, ref.fedavg_reduce_leaves_ref(table), rtol=0, atol=1e-5)


# An MoE model keeps its router in fp32 beside bf16 weights: leaves "b" and
# "d" of the ragged layout in fp32 among bf16 ones.  A launch reads one
# dtype, so ``leaf_mean`` takes one call a dtype; each leaf is held at its
# own dtype's tolerance.
MIXED = {"a": "bfloat16", "b": "float32", "c": "bfloat16", "d": "float32", "e": "bfloat16"}


def mixed_case(seed):
    rng = np.random.default_rng(seed)
    trees = [{n: stacked(rng, {n: RAGGED[n]}, k, MIXED[n])[n] for n in RAGGED} for k in (CAP, N, 1)]
    slab, old, fb = trees
    return slab, np.array([1, 0, 1, 1], bool), old, np.arange(N) % 4 == 3, {k: v[0] for k, v in fb.items()}


def mixed_torch(tree, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(TORCH_DTYPES[MIXED[k]]).to(device) for k, v in tree.items()}


@pytest.mark.parametrize("path", ["plain", "pallas"])
@pytest.mark.parametrize("groups", [1, 2])
def test_mixed_dtype_leaves_match_reference(groups, path):
    import jax.numpy as jnp
    from repro.core import simulator as jsim

    slab, slab_mask, old, old_mask, fb = mixed_case(12)
    to_j = lambda tree: {k: jnp.asarray(v, getattr(jnp, MIXED[k])) for k, v in tree.items()}  # noqa: E731
    if groups == 2:
        got = tsim._compact_mean(mixed_torch(slab), torch.from_numpy(slab_mask), mixed_torch(old),
                                 torch.from_numpy(old_mask), mixed_torch(fb))
        want = jsim._compact_mean(to_j(slab), jnp.asarray(slab_mask), to_j(old), jnp.asarray(old_mask), to_j(fb),
                                  use_kernel=path == "pallas")
    else:
        got = tsim._masked_mean(mixed_torch(old), torch.from_numpy(old_mask), mixed_torch(fb))
        fn = jsim._masked_mean_kernel if path == "pallas" else jsim._masked_mean
        want = fn(to_j(old), jnp.asarray(old_mask), to_j(fb))
    assert list(got) == sorted(RAGGED) and all(got[k].dtype == TORCH_DTYPES[MIXED[k]] for k in got)
    got, want = as_numpy(got), as_numpy(want)
    for k in RAGGED:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL[MIXED[k]], err_msg=k)


@pytest.mark.cuda
def test_mixed_dtype_leaves_launch_once_per_dtype(cuda_device):
    """Two dtypes, two launches (each over both row groups), against the
    same mean on the CPU."""
    slab, slab_mask, old, old_mask, fb = mixed_case(13)
    cpu = tsim._compact_mean(mixed_torch(slab), torch.from_numpy(slab_mask), mixed_torch(old),
                             torch.from_numpy(old_mask), mixed_torch(fb))
    before = (fedavg_kernel.launches, fedavg_kernel.row_groups)
    gpu = tsim._compact_mean(mixed_torch(slab, cuda_device), torch.from_numpy(slab_mask).to(cuda_device),
                             mixed_torch(old, cuda_device), torch.from_numpy(old_mask).to(cuda_device),
                             mixed_torch(fb, cuda_device))
    assert (fedavg_kernel.launches, fedavg_kernel.row_groups) == (before[0] + 2, before[1] + 4)
    for k in cpu:
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=0, atol=1e-6)
