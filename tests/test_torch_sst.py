"""The port's SST backbone (``ops/window.py``, ``models/sst.py``) against the
JAX package's on the CPU, on voxels drawn with numpy, the flax variable tree
carried across by ``weights.from_jax_variables`` (its attention kernels
included) with ``strict=True``.

The window functions run eagerly on the JAX side. The backbone compiles one
JAX ``value_and_grad`` per module (a module-scoped fixture; XLA's backend
optimisation is turned down, which only moves the reference by float
rounding), at a size where the regular partition fits ``windows_cap``, the
shifted one overflows it and ``max_tokens`` drops tokens, so both of the
reference's quirks are on the compared path.

Tolerances:

* the partition, the window scatter / gather and the masks: equal;
* the position embedding: ``ULP`` 2^-23 absolute, one f32 ulp at its
  scale (values in [-1, 1]): the same f32 operations in the same order, but
  XLA's and PyTorch's f32 ``exp``, ``sin`` and ``cos`` land one ulp apart
  on a few per cent of the entries;
* ``WindowAttentionBlock``, the backbone's output: ``F32_TOL`` 1e-5 of the
  output's largest magnitude (f32 sums in another order);
* the backbone's parameter gradients: ``GRAD_TOL`` 1e-4 of each leaf's
  largest magnitude. The attention's ``key`` bias is the exception: the
  softmax over keys does not change when every logit of a row moves by
  the same amount, so its gradient is 0 in exact arithmetic and rounding
  noise on both sides; both are held within ``GRAD_TOL`` of the same
  layer's ``value`` bias gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.models import sst as jsst
from fullysparsefusion_tpu.ops import window as jwin
from fullysparsefusion_tpu_torch.models.sst import SSTBackbone, WindowAttentionBlock
from fullysparsefusion_tpu_torch.ops import window as twin
from fullysparsefusion_tpu_torch.weights import from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import FAST_COMPILE, _numpy_variables

F32_TOL = 1e-5
GRAD_TOL = 1e-4
ULP = 2.0 ** -23
# the backbone case: 2 samples on a 64 x 64 grid, 8 x 8 windows; the regular
# partition has at most 128 windows, the shifted one up to 162
SST_KW = dict(dim=32, num_blocks=2, num_heads=4, sparse_shape=(64, 64, 1),
              window_shape=(8, 8, 1), max_tokens=4, windows_cap=128)


def _voxels(seed=0, n=400, cap=512, in_dim=16, grid=64):
    """``tests/test_sst.py``'s voxels: random coords (duplicates allowed),
    batch ids and features, padded to ``cap`` rows."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((cap, 3), np.int32)
    coords[:n, :2] = rng.integers(0, grid, (n, 2))
    batch = np.zeros(cap, np.int32)
    batch[:n] = rng.integers(0, 2, n)
    feats = np.zeros((cap, in_dim), np.float32)
    feats[:n] = rng.normal(size=(n, in_dim))
    return feats, coords, batch, np.arange(cap) < n


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, ref, what=""):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref), err_msg=what)


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max(initial=0)), err_msg=what)


def _partitions(seed, shift, windows_cap, grid=64, window=(8, 8, 1)):
    _, coords, batch, valid = _voxels(seed, grid=grid)
    args = ((grid, grid, 1), window, shift, windows_cap)
    ref = jwin.window_partition(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid),
                                *args)
    got = twin.window_partition(_t(coords), _t(batch), _t(valid), *args)
    return (coords, batch, valid), ref, got


@pytest.mark.parametrize("shift", [False, True], ids=["regular", "shifted"])
@pytest.mark.parametrize("windows_cap", [256, 100], ids=["fits", "overflow"])
def test_window_partition_matches_jax(shift, windows_cap):
    (_, _, valid), ref, got = _partitions(0, shift, windows_cap)
    for f in ("seg_id", "unique_keys", "counts", "num_segments", "seg_valid"):
        _eq(getattr(got.seg, f), getattr(ref.seg, f), f)
    _eq(got.inner_idx, ref.inner_idx)
    _eq(got.win_coords, ref.win_coords)
    _eq(got.tokens_per_win, ref.tokens_per_win)
    overflow = int(ref.seg.num_segments) > windows_cap
    assert overflow == (windows_cap == 100)
    assert bool((got.seg.seg_id[_t(valid)] == windows_cap).any()) == overflow


@pytest.mark.parametrize("shift", [False, True], ids=["regular", "shifted"])
@pytest.mark.parametrize("windows_cap", [256, 100], ids=["fits", "overflow"])
def test_window_scatter_and_gather_match_jax(shift, windows_cap):
    """``flat_to_window`` (tokens past ``max_tokens`` dropped, overflowed
    windows to the trash row) and ``window_to_flat`` (overflowed windows'
    voxels read the last window's token at their inner index)."""
    (_, _, valid), ref, got = _partitions(1, shift, windows_cap)
    max_tokens = 3
    feats = np.random.default_rng(2).normal(size=(valid.shape[0], 5)).astype(np.float32)
    jw, jm = jwin.flat_to_window(jnp.asarray(feats), ref, jnp.asarray(valid), max_tokens)
    tw, tm = twin.flat_to_window(_t(feats), got, _t(valid), max_tokens)
    _eq(tw, jw), _eq(tm, jm)
    assert int((np.asarray(ref.inner_idx) >= max_tokens).sum()) > 0
    back_j = jwin.window_to_flat(jw, ref, jnp.asarray(valid), max_tokens)
    back_t = twin.window_to_flat(tw, got, _t(valid), max_tokens)
    _eq(back_t, back_j)
    if windows_cap == 100:   # overflowed voxels read a row that is not theirs
        lost = (np.asarray(ref.seg.seg_id) == windows_cap) & valid \
            & (np.asarray(ref.inner_idx) < max_tokens)
        assert lost.any()
        assert not np.array_equal(np.asarray(back_j)[lost], feats[lost])


def test_window_position_embedding_matches_jax():
    _, coords, _, _ = _voxels(3)
    for dim in (32, 128):
        ref = jwin.window_position_embedding(jnp.asarray(coords), None, (16, 16, 1), dim)
        got = twin.window_position_embedding(_t(coords), None, (16, 16, 1), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ULP,
                                   err_msg=f"dim {dim}")
        assert got.shape == (coords.shape[0], dim)


def test_window_attention_block_with_an_empty_window_matches_jax():
    """A window with no valid token: flax fills its logits with the lowest
    f32, so its softmax is uniform and finite and the ``* mask`` returns the
    tokens as they came in, on both sides."""
    rng = np.random.default_rng(4)
    tokens = rng.normal(size=(6, 8, 32)).astype(np.float32)
    mask = rng.random((6, 8)) > 0.4
    mask[2] = False
    mask[4] = True
    block = jsst.WindowAttentionBlock(dim=32, num_heads=4, ffn_dim=64)
    shapes = jax.eval_shape(lambda k: block.init(k, jnp.asarray(tokens), jnp.asarray(mask)),
                            jax.random.key(0))
    jvars = _numpy_variables(shapes, seed=5)
    ref = block.apply(jvars, jnp.asarray(tokens), jnp.asarray(mask))
    m = WindowAttentionBlock(32, 4, 64)
    m.load_state_dict(from_jax_variables(jvars), strict=True)
    got = m(_t(tokens), _t(mask))
    assert torch.isfinite(got).all()
    _close(got, ref, F32_TOL)
    _eq(got[2], tokens[2])
    np.testing.assert_array_equal(np.asarray(ref)[2], tokens[2])


@pytest.fixture(scope="module")
def backbone():
    """The JAX backbone's output and parameter gradients of Σ out² (one
    compile), the port's from the same variables, and the port's output
    with the padding rows' features set to 77."""
    feats, coords, batch, valid = _voxels(6)
    jm = jsst.SSTBackbone(**SST_KW)
    args = [jnp.asarray(a) for a in (feats, coords, batch, valid)]
    shapes = jax.eval_shape(lambda k: jm.init(k, *args), jax.random.key(0))
    jvars = _numpy_variables(shapes, seed=7)

    def run(params):
        def loss(p):
            out = jm.apply({"params": p}, *args)
            return jnp.sum(out ** 2), out

        return jax.value_and_grad(loss, has_aux=True)(params)

    (jloss, jout), jgrads = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(jvars["params"]))
    m = SSTBackbone(feats.shape[1], **SST_KW)
    m.load_state_dict(from_jax_variables(jvars), strict=True)
    targs = [_t(a) for a in (feats, coords, batch, valid)]
    out = m(*targs)
    loss = (out ** 2).sum()
    loss.backward()
    with torch.no_grad():
        padded = m(torch.where(targs[3][:, None], targs[0], torch.full_like(targs[0], 77.0)),
                   *targs[1:])
    parts = m.partitions(*targs[1:])
    return dict(jvars=jvars, jloss=jloss, jout=jout, jgrads=jgrads, model=m, out=out, loss=loss,
                padded=padded, valid=valid, parts=parts)


def test_sst_case_drops_tokens_and_overflows_the_shifted_windows(backbone):
    regular, shifted = backbone["parts"]
    cap = SST_KW["windows_cap"]
    assert int(regular.seg.num_segments) <= cap < int(shifted.seg.num_segments)
    assert int((regular.inner_idx >= SST_KW["max_tokens"]).sum()) > 0


def test_sst_backbone_forward_matches_jax(backbone):
    _close(backbone["out"], backbone["jout"], F32_TOL)
    _close(backbone["loss"], backbone["jloss"], F32_TOL)
    out = backbone["out"].detach()
    assert out.shape == (512, SST_KW["dim"]) and torch.isfinite(out).all()
    assert not out[torch.from_numpy(~backbone["valid"])].any()


def test_sst_backbone_parameter_gradients_match_jax(backbone):
    ref = from_jax_variables({"params": backbone["jgrads"]})
    grads = {n: p.grad for n, p in backbone["model"].named_parameters()}
    assert set(ref) == set(grads) and len(ref) == 2 + 16 * SST_KW["num_blocks"]
    for k, g in ref.items():
        if k.endswith(".key.bias"):
            scale = float(ref[k.replace(".key.", ".value.")].abs().max())
            assert max(float(g.abs().max()), float(grads[k].abs().max())) <= GRAD_TOL * scale, k
            continue
        _close(grads[k], g.numpy(), GRAD_TOL, k)
        assert float(g.abs().max()) > 0, k


def test_sst_backbone_padding_rows_do_not_reach_the_output(backbone):
    """``tests/test_sst.py``'s padding invariance: padding features of 77
    change no valid row (within 1e-5, as there), and padding rows stay 0."""
    valid = torch.from_numpy(backbone["valid"])
    out, padded = backbone["out"].detach(), backbone["padded"]
    np.testing.assert_allclose(padded[valid].numpy(), out[valid].numpy(), atol=1e-5)
    assert not padded[~valid].any()
