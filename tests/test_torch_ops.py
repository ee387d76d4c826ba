"""The port's ops (beach_seg_tpu_torch.ops) against the JAX package's on the
same seeded inputs: resize matrices bit for bit, the device resizes, the
attention oracle, and the plain versions of the two CUDA kernels against the
Pallas kernels (interpret mode on the CPU). Also the shape constants kept on
their device (``utils.device.device_constant``): the resize matrices, the
rel-pos index and the masked-position mask, copied once and never written."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.ops import attention as jattn
from beach_seg_tpu.ops import pallas_attn, pallas_mlp
from beach_seg_tpu.ops import resize as jresize
from beach_seg_tpu_torch.ops import attention as tattn
from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import SegGPTConfig, default_bool_masked_pos, tiny_config
from beach_seg_tpu_torch.models.seggpt import model as model_module
from beach_seg_tpu_torch.ops import resize as tresize
from beach_seg_tpu_torch.utils import device as udevice

BF16_EPS = 2.0**-8  # bf16 relative rounding step (8 significand bits)

METHODS = sorted(jresize._KERNELS) + ["nearest_pil", "nearest_torch", "nearest_floor", "nearest_cv2"]
# crop→canvas, canvas→crop, abs-pos 14→56/28, rel-pos tables, tiny sizes, an odd one
SIZES = [(112, 448), (448, 112), (14, 56), (14, 28), (55, 111), (4, 8), (448, 48), (37, 23)]


@pytest.fixture
def uploads(monkeypatch):
    """An empty constant cache for the test, and the list of host data that
    ``device_constant`` copies to a device."""
    monkeypatch.setattr(udevice, "_CONSTANTS", {})
    seen = []
    real = udevice.tensor_from_host

    def counted(data, dtype=None, device=None):
        seen.append(data)
        return real(data, dtype=dtype, device=device)

    monkeypatch.setattr(udevice, "tensor_from_host", counted)
    return seen


def _assert_device_matrix(n_in, n_out, method, **kw):
    """``_matrix`` equals the host matrix built fresh, and a second call (the
    device spelled another way) returns the same tensor."""
    got = tresize._matrix(n_in, n_out, method, torch.device("cpu"), **kw)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), tresize.resize_matrix(n_in, n_out, method, **kw))
    assert tresize._matrix(n_in, n_out, method, "cpu", **kw) is got


@pytest.mark.parametrize("method", METHODS)
def test_resize_matrix_bit_equal(method, uploads):
    for n_in, n_out in SIZES:
        np.testing.assert_array_equal(
            tresize.resize_matrix(n_in, n_out, method), jresize.resize_matrix(n_in, n_out, method)
        )
        _assert_device_matrix(n_in, n_out, method)
    if not method.startswith("nearest"):
        for kw in (dict(antialias=True), dict(antialias=False), dict(align_corners=True)):
            np.testing.assert_array_equal(
                tresize.resize_matrix(112, 448, method, **kw), jresize.resize_matrix(112, 448, method, **kw)
            )
            np.testing.assert_array_equal(
                tresize.resize_matrix(448, 112, method, **kw), jresize.resize_matrix(448, 112, method, **kw)
            )
            _assert_device_matrix(112, 448, method, **kw)
            _assert_device_matrix(448, 112, method, **kw)
    # one copy per sizes and options, none on the second call
    assert len(uploads) == len(udevice._CONSTANTS) == len(SIZES) + (0 if method.startswith("nearest") else 6)


@pytest.mark.parametrize("hw_in,hw_out", [((112, 112), (448, 448)), ((448, 448), (112, 112))])
def test_resize_pil_uint8_device_matches_jax(hw_in, hw_out):
    """Both sides are fp32 products rounded to uint8 between passes; fp32 sums
    that land on the other side of a .5 boundary may differ by 1 (the JAX
    docstring's ≲5e-5 of pixels against the f64 host path), never more."""
    img = np.random.default_rng(0).integers(0, 256, (2, *hw_in, 3), dtype=np.uint8)
    want = np.asarray(jresize.resize_pil_uint8_device(jnp.asarray(img), hw_out))
    got = tresize.resize_pil_uint8_device(torch.from_numpy(img), hw_out).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-4


def test_resize_2d_and_1d_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((1, 64, 14, 14)).astype(np.float32)  # abs-pos grid, channels first
    want = np.asarray(jresize.resize_2d(jnp.asarray(grid), (56, 28), "bicubic_torch"))
    got = tresize.resize_2d(torch.from_numpy(grid), (56, 28), "bicubic_torch").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ids = rng.integers(0, 4, (2, 16, 16)).astype(np.int32)
    want = np.asarray(jresize.resize_2d(jnp.asarray(ids), (8, 40), "nearest_cv2"))
    got = tresize.resize_2d(torch.from_numpy(ids), (8, 40), "nearest_cv2").numpy()
    np.testing.assert_array_equal(got, want)
    table = rng.standard_normal((27, 64)).astype(np.float32)
    want = np.asarray(jresize.resize_1d(jnp.asarray(table), 111))
    got = tresize.resize_1d(torch.from_numpy(table), 111).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("q_size,k_size,table_len", [(8, 8, 15), (4, 4, 7), (8, 8, 9), (6, 3, 11)])
def test_get_rel_pos_matches_jax(q_size, k_size, table_len, uploads):
    """Twice, equal both times; the index (and the table's resize matrix,
    where the table is resized) is copied to the device on the first call
    only."""
    table = np.random.default_rng(2).standard_normal((table_len, 16)).astype(np.float32)
    want = np.asarray(jattn.get_rel_pos(q_size, k_size, jnp.asarray(table)))
    got = tattn.get_rel_pos(q_size, k_size, torch.from_numpy(table)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    first = len(uploads)
    assert first == (1 if table_len == 2 * max(q_size, k_size) - 1 else 2)
    again = tattn.get_rel_pos(q_size, k_size, torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(again, got)
    assert len(uploads) == first
    idx = udevice._CONSTANTS[(tattn._rel_pos_index, (q_size, k_size), torch.device("cpu"))]
    assert idx.dtype == torch.int64 and not idx.requires_grad


@pytest.mark.parametrize("config", [tiny_config(), SegGPTConfig(), SegGPTConfig(image_size=(448, 224))],
                         ids=["tiny", "vit_l", "vit_l_224"])
def test_default_bool_masked_pos_cached_equals_fresh(config, uploads):
    """The cached mask equals the one built fresh (the query half masked),
    whatever the batch and however the device is spelled; one copy in all."""
    n = config.num_patches
    fresh = torch.cat([torch.zeros(n // 2, dtype=torch.bool), torch.ones(n - n // 2, dtype=torch.bool)])
    for batch, device in ((2, None), (3, "cpu"), (1, torch.device("cpu"))):
        got = default_bool_masked_pos(config, batch, device)
        assert got.shape == (batch, n) and got.dtype == torch.bool
        assert torch.equal(got, fresh[None, :].expand(batch, n))
    assert len(uploads) == 1


def test_indexed_device_names_one_card(monkeypatch):
    """``cuda`` and ``cuda:<current>`` key one cache entry; each card its own."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert udevice.indexed_device("cuda") == udevice.indexed_device("cuda:1") == torch.device("cuda", 1)
    assert udevice.indexed_device("cuda:0") != udevice.indexed_device("cuda")
    assert udevice.indexed_device(None) == udevice.indexed_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_debug_backbone_step_leaves_cached_constants_unchanged(dtype, uploads):
    """A debug-backbone forward and backward (labels, a gradient to the prompt
    pixels) on a grid whose abs-pos table is resized: the first step fills
    the cache with the rel-pos indices, the resize matrices and the mask; a
    second step copies nothing more and leaves every cached tensor as it
    was, bit for bit, with no in-place write and no autograd history."""
    from beach_seg_tpu_torch.train.loop import model_for_config

    model, cfg = model_for_config(BeachSegConfig(debug=True, inpt_size=64, compute_dtype=dtype), device="cpu")
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    x, px, pm, lab = (torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(4))

    def step():
        leaf = px.clone().requires_grad_(True)
        out = model(x, leaf, pm, labels=lab, decode_query_only=True)
        (grad,) = torch.autograd.grad(out["loss"], leaf)
        assert torch.isfinite(grad).all()

    step()
    cached = dict(udevice._CONSTANTS)
    assert {fn for fn, _, _ in cached} == {tattn._rel_pos_index, tresize.resize_matrix, model_module._query_half_mask}
    before = {k: (t.clone(), t._version) for k, t in cached.items()}
    n_uploads = len(uploads)
    with torch.inference_mode():
        model(x, px, pm, decode_query_only=True)
    step()
    assert len(uploads) == n_uploads and udevice._CONSTANTS.keys() == cached.keys()
    for k, t in cached.items():
        assert udevice._CONSTANTS[k] is t, k
        want, version = before[k]
        assert t._version == version and not t.requires_grad and not t.is_inference(), k
        assert torch.equal(t.view(torch.uint8), want.view(torch.uint8)), k


@pytest.fixture(scope="module")
def qkv_inputs():
    """The JAX suite's flagship head geometry (head_dim 64, two heads) on a
    tiny grid, with a nonzero qkv bias."""
    rng = np.random.default_rng(1)
    b, nh, hd, gh, gw = 2, 2, 64, 8, 4
    c = nh * hd
    qkv = rng.standard_normal((b, gh * gw, 3, c)).astype(np.float32)
    bias = rng.standard_normal((3, c)).astype(np.float32)
    rel_pos_h = rng.standard_normal((2 * gh - 1, hd)).astype(np.float32)
    rel_pos_w = rng.standard_normal((2 * gw - 1, hd)).astype(np.float32)
    return qkv, bias, rel_pos_h, rel_pos_w, nh, hd, gh, gw


def test_rel_tables_and_terms_match_jax(qkv_inputs):
    qkv, _, rph, rpw, nh, hd, gh, gw = qkv_inputs
    want = jattn.rel_tables_padded(jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    got = tattn.rel_tables_padded(torch.from_numpy(rph), torch.from_numpy(rpw), (gh, gw), (gh, gw))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    q = qkv[:, :, 0, :hd]
    want = jattn.rel_pos_terms(jnp.asarray(q), jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    got = tattn.rel_pos_terms(torch.from_numpy(q), torch.from_numpy(rph), torch.from_numpy(rpw), (gh, gw), (gh, gw))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def _split_heads(qkv, nh, hd):
    b, s = qkv.shape[:2]
    split = qkv.reshape(b, s, 3, nh, hd).transpose(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
    return split[0], split[1], split[2]


def test_attention_reference_and_packed_match_jax(qkv_inputs):
    """attention_reference (fp32 softmax) and the plain version of
    ``_kernel_packed`` against the JAX oracle and the Pallas packed kernel."""
    qkv, _, rph, rpw, nh, hd, gh, gw = qkv_inputs
    s = gh * gw
    q, k, v = _split_heads(qkv, nh, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jrh, jrw = jattn.rel_pos_terms(jq, jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    want = np.asarray(jattn.attention_reference(jq, jk, jv, jrh, jrw, hd**-0.5))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    trh, trw = tattn.rel_pos_terms(tq, torch.from_numpy(rph), torch.from_numpy(rpw), (gh, gw), (gh, gw))
    got = tattn.attention_reference(tq, tk, tv, trh, trw, hd**-0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want = np.asarray(
        pallas_attn.fused_attention_merged(jq, jk, jv, jrh.reshape(-1, s, gh), jrw.reshape(-1, s, gw), hd**-0.5, gh, gw, nh)
    )
    got = tattn.attention_packed_plain(tq, tk, tv, trh.reshape(-1, s, gh), trw.reshape(-1, s, gw), hd**-0.5, nh).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_qkv_rel(qkv, bias, rph, rpw, nh, hd, gh, gw, dtype, softmax=None):
    rh, rw = jattn.rel_tables_padded(jnp.asarray(rph, dtype), jnp.asarray(rpw, dtype), (gh, gw), (gh, gw))
    qkv4, jbias = jnp.asarray(qkv, dtype), jnp.asarray(bias, dtype)
    if softmax is None:  # the public entry, mode by dtype
        out = pallas_attn.fused_attention_qkv_rel(qkv4, jbias, rh, rw, hd**-0.5, gw, nh)
    else:
        b, s, _, c = qkv.shape
        out = pallas_attn._pallas_attention_qkv_rel(
            qkv4.reshape(b, s, 3 * c), rh, rw, hd**-0.5, nh, interpret=True, softmax=softmax, qkv_bias=jbias
        )
    return np.asarray(out.astype(jnp.float32))


def _port_qkv_rel(qkv, bias, rph, rpw, nh, hd, gh, gw, dtype, softmax=None):
    rh, rw = tattn.rel_tables_padded(torch.from_numpy(rph).to(dtype), torch.from_numpy(rpw).to(dtype), (gh, gw), (gh, gw))
    out = cuda_attn.attn_qkv_rel(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(bias).to(dtype), rh, rw, hd**-0.5, gw, nh, softmax
    )
    return out.float().numpy()


def test_attn_qkv_rel_plain_matches_jax_fp32(qkv_inputs):
    """CPU tensors take the plain version; fp32 within the 1e-5 the JAX suite
    holds its own kernel to (test_pallas_attn.py:151)."""
    want = _jax_qkv_rel(*qkv_inputs, jnp.float32)
    got = _port_qkv_rel(*qkv_inputs, torch.float32)
    assert got.shape == want.shape == (2, 32, 128)
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("softmax", ["stable", "clamp", "fast"])
def test_attn_qkv_rel_softmax_modes_match_jax(qkv_inputs, softmax):
    want = _jax_qkv_rel(*qkv_inputs, jnp.float32, softmax)
    got = _port_qkv_rel(*qkv_inputs, torch.float32, softmax)
    assert np.abs(got - want).max() < 1e-5


def test_attn_qkv_rel_plain_matches_jax_bf16(qkv_inputs):
    """bf16 under the default ``clamp``: the rounding points are the same, but
    fp32 sums in another order can round a q/k/p/out value to the
    neighbouring bf16, so allow two bf16 steps of the output's scale."""
    want = _jax_qkv_rel(*qkv_inputs, jnp.bfloat16)
    got = _port_qkv_rel(*qkv_inputs, torch.bfloat16)
    assert np.abs(got - want).max() <= 2 * BF16_EPS * np.abs(want).max()


@pytest.fixture(scope="module")
def mlp_inputs():
    rng = np.random.default_rng(3)
    n, c, m = 64, 128, 512
    x = rng.standard_normal((2, n // 2, c)).astype(np.float32)
    ls = rng.standard_normal((c,)).astype(np.float32)
    lb = rng.standard_normal((c,)).astype(np.float32)
    w1 = (rng.standard_normal((c, m)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal((m,)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((m, c)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal((c,)) * 0.05).astype(np.float32)
    return x, ls, lb, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approx", [False, True])
def test_ln_mlp_plain_matches_jax(mlp_inputs, approx, dtype):
    """fp32 within 1e-5 (the JAX suite's own kernel bar); bf16 within two
    bf16 steps of the output's scale (LN and h are rounded to bf16 at the
    same points, fp32 sums in another order may round to the neighbour)."""
    x, ls, lb, w1, b1, w2, b2 = mlp_inputs
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_mlp.fused_ln_mlp(
        jnp.asarray(x, jdt), jnp.asarray(ls), jnp.asarray(lb), *(jnp.asarray(a, jdt) for a in (w1, b1, w2, b2)),
        1e-6, approx,
    )
    want = np.asarray(want.astype(jnp.float32))
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    got = cuda_mlp.ln_mlp(t(x), torch.from_numpy(ls), torch.from_numpy(lb), t(w1), t(b1), t(w2), t(b2), 1e-6, approx)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err < (1e-5 if dtype == "float32" else 2 * BF16_EPS * np.abs(want).max())


# each attention wrapper's operands as it hands them to
# cuda_attn._check_operands: those held to the first one's dtype,
# contiguity and 16-byte alignment, then those it casts itself
_OPERANDS = {
    "attn_qkv_rel": (("qkv4", "qkv_bias", "rh_tab", "rw_tab"), ()),
    "attn_packed": (("q", "k", "v"), ("rel_h", "rel_w")),
    "attn_bwd": (("q", "k", "v", "g", "rel_h", "rel_w"), ()),
    "attn_fused": (("q", "k", "v", "rel_h", "rel_w"), ()),
    "attn_qkv": (("qkv",), ("rel_h64", "rel_w64")),
}
_KINDS = ("accepted", "shape", "dtype", "strided", "offset", "ref_dtype", "cast_dtype", "cast_shape")


@pytest.mark.parametrize("name,kind", [
    (name, kind) for name, (strict, cast) in _OPERANDS.items() for kind in _KINDS
    if (kind != "dtype" or len(strict) > 1) and (not kind.startswith("cast") or cast)
])
def test_attention_operand_check(name, kind):
    """The wrappers' one operand check, on CPU tensors (the wrappers reach
    it only for CUDA ones): a wrong shape, a dtype other than the
    reference's where the wrapper requires it, a non-contiguous view, a view
    2 bytes past a 16-byte boundary and a reference in fp16 each raise with
    the wrapper's name; an operand the wrapper casts may have another dtype
    but not another shape."""
    strict, cast = _OPERANDS[name]
    shape = (4, 8)
    t = {op: torch.zeros(shape, dtype=torch.bfloat16) for op in strict + cast}
    last = strict[-1]
    if kind == "shape":
        t[last] = torch.zeros((4, 9), dtype=torch.bfloat16)
    elif kind == "dtype":
        t[last] = t[last].float()
    elif kind == "strided":
        t[last] = torch.zeros(shape[::-1], dtype=torch.bfloat16).T
    elif kind == "offset":
        t[last] = torch.zeros(33, dtype=torch.bfloat16)[1:].view(shape)
        assert t[last].is_contiguous() and t[last].data_ptr() % 16 == 2
    elif kind == "ref_dtype":
        t[strict[0]] = t[strict[0]].half()
    elif kind == "cast_dtype":
        t[cast[0]] = t[cast[0]].float()
    elif kind == "cast_shape":
        last = cast[-1]
        t[last] = torch.zeros((4, 9), dtype=torch.bfloat16)

    def check():
        cuda_attn._check_operands(name, t[strict[0]], [(op, t[op], shape) for op in strict],
                                  cast=[(op, t[op], shape) for op in cast])

    if kind in ("accepted", "cast_dtype"):
        check()
    elif kind == "ref_dtype":
        with pytest.raises(TypeError, match=rf"^{name} kernel takes bf16 or fp32"):
            check()
    else:
        with pytest.raises(ValueError, match=rf"^{name} kernel\b.*\b{last}\b"):
            check()
