"""The port's flash attention path (sagan_tpu_torch/ops) against the JAX
package's flash kernels run in interpret mode, on the same numpy inputs:
the plain forward against ``_flash_fwd`` (o and lse), the plain backward
against ``_flash_bwd_fused`` and ``_flash_bwd`` on the same (o, lse),
``FlashAttention`` against ``jax.vjp`` of ``_attention_flash``; the
port's routing against the JAX dispatch at every vanilla model shape the
kernels take at B <= 4, and its fused-backward rule's byte arithmetic; past
both packages' slab budgets, ``FlashAttention``'s two-kernel backward
against ``jax.vjp`` through the JAX two-kernel backward; the wrappers'
plumbing (engines, key blocks, launches, profile names); and the church512
weights carried across by ``convert``.

Tolerances, each as a share of the largest magnitude of the JAX value
(of max(1, that) for o and lse):
* forward o: fp32 1e-5 (same arithmetic, the JAX kernel's key blocks
  rescale the running sums in another order); bf16 2e-2 (the JAX kernel
  casts exp(L − running max) to bf16 per key block, the plain version
  exp(L − max) once, and both round o to bf16);
* lse: 1e-5 in both dtypes (fp32 from the same logits, other order);
* backward on the same (o, lse): fp32 1e-5 (other summation order); bf16
  4e-3, one bf16 ulp (2^-8): both round dL and P to bf16 at the same
  places and the outputs to bf16;
* ``FlashAttention`` against ``jax.vjp``: as the forward, and the
  gradients as the backward in fp32; bf16 2e-2, since each side's
  gradients start from its own o;
* chunked against unchunked: the forward equal; the backward's fp32 dK,
  dV sums reordered, 1e-5 (fp32) and 4e-3 (bf16, after the outputs'
  rounding);
* the plain fp32 dq against float64 arithmetic on the same inputs: 1e-5
  (fp32 logits and sums of up to 1,024 keys a block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.models import get_discriminator as jax_discriminator
from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.ops import pallas_attention as pa
from sagan_tpu.utils.config import load_config_file
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu_torch.convert import (flat_from_jax_tree, jax_flat_from_module,
                                     state_from_jax)
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.ops import attention as attention_ops
from sagan_tpu_torch.ops import cuda_attention
from sagan_tpu_torch.ops.attention import (DQ_SLAB_BUDGET, K2_FILL,
                                           MMA_BWD_WARPS, MMA_K6_WARPS,
                                           PLAIN_KEY_BLOCK, attention,
                                           attention_flash_bwd_reference,
                                           attention_flash_reference,
                                           attention_reference, dq_slab_bytes,
                                           flash_bwd_fused,
                                           fused_keys_per_block,
                                           k2_key_blocks, k6_warps,
                                           mma_key_tiles, plain_chunk,
                                           single_pass)
from sagan_tpu_torch.tools.profiling import attention_kernels
from sagan_tpu_torch.utils.config import resolve_config

FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-5
BWD_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
VJP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# JAX blocks of the interpret-mode runs, the shapes of
# tests/test_pallas_kernels.py:244-270: B 2, N 512, M 2048
B, N, M = 2, 512, 2048
FWD_BLOCKS = (256, 512)
BWD_BLOCKS = {"fused": (128, 1024), "two_kernel": (128, 256)}


def _arrays(d, c, b=B, n=N, m=M, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32)
            for s in ((b, n, d), (b, m, d), (b, m, c), (b, n, c))]


def _port(arrays, dtype):
    return [torch.from_numpy(np.array(a)).to(getattr(torch, dtype))
            for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _share(got, want):
    """max|got − want| as a share of max|want|."""
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / \
        np.abs(want).max()


def _flat(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c", [(2, 8), (8, 16)])
def test_plain_flash_forward_matches_jax_flash_kernel(d, c, dtype):
    arrays = _arrays(d, c)
    jo, jlse = pa._flash_fwd(*_jax(arrays[:3], dtype), *FWD_BLOCKS, 1,
                             interpret=True)
    o, lse = attention_flash_reference(*_port(arrays[:3], dtype))
    assert o.dtype == getattr(torch, dtype) and o.shape == (B, N, c)
    assert lse.dtype == torch.float32 and lse.shape == (B, N, 1)
    jo, jlse = np.asarray(jo, np.float32), np.asarray(jlse)
    assert np.abs(_flat(o) - jo).max() <= \
        FWD_TOL[dtype] * max(1.0, np.abs(jo).max())
    assert np.abs(lse.numpy() - jlse).max() <= \
        LSE_TOL * max(1.0, np.abs(jlse).max())


@pytest.mark.parametrize("kernel", ["fused", "two_kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_backward_matches_jax_flash_kernels(dtype, kernel):
    """On the same (o, lse) from the JAX forward: ``_flash_bwd_fused``
    (K6's TPU kernel) and ``_flash_bwd`` (K4 + K5's)."""
    q, k, v, g = _jax(_arrays(8, 16, seed=1), dtype)
    o, lse = pa._flash_fwd(q, k, v, *FWD_BLOCKS, 1, interpret=True)
    bn, bm = BWD_BLOCKS[kernel]
    if kernel == "fused":
        want = pa._flash_bwd_fused(q, k, v, o, lse, g, bn, bm,
                                   interpret=True)
    else:
        want = pa._flash_bwd(q, k, v, o, lse, g, bn, bm, 1, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(getattr(torch, dtype)) for a in (q, k, v, g))
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tq.dtype)
    got = attention_flash_bwd_reference(tq, tk, tv, to,
                                        torch.from_numpy(np.array(lse)), tg)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == tq.dtype and x.shape == w.shape, name
        assert _share(_flat(x), w) <= BWD_TOL[dtype], (name, _share(_flat(x),
                                                                    w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2048, 1024])
def test_flash_autograd_function_matches_jax_attention_flash(m, dtype):
    """``FlashAttention`` on the CPU against ``jax.vjp`` of the JAX
    flash op, whose backward is the fused kernel at M=2048 and the two
    kernels at M=1024 (the fused picker needs two key blocks)."""
    arrays = _arrays(8, 16, m=m, seed=2)
    jq, jk, jv, jg = _jax(arrays, dtype)
    jo, vjp = jax.vjp(lambda q, k, v: pa._attention_flash(
        q, k, v, *BWD_BLOCKS["two_kernel"], *FWD_BLOCKS, 1, True), jq, jk, jv)
    q, k, v, g = _port(arrays, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = cuda_attention.FlashAttention.apply(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    jo = np.asarray(jo, np.float32)
    assert np.abs(_flat(o) - jo).max() <= \
        FWD_TOL[dtype] * max(1.0, np.abs(jo).max())
    grads = torch.autograd.grad(o, (q, k, v), g)
    for name, x, w in zip(("dq", "dk", "dv"), grads, vjp(jg)):
        assert x.dtype == getattr(torch, dtype), name
        assert _share(_flat(x), w) <= VJP_TOL[dtype], (name, _share(_flat(x),
                                                                    w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_plain_matches_unchunked(dtype):
    q, k, v, g = _port(_arrays(2, 8, seed=3), dtype)
    o, lse = attention_flash_reference(q, k, v)
    o100, lse100 = attention_flash_reference(q, k, v, chunk=100)
    assert torch.equal(o, o100) and torch.equal(lse, lse100)
    assert torch.equal(attention_reference(q, k, v),
                       attention_reference(q, k, v, chunk=100))
    whole = attention_flash_bwd_reference(q, k, v, o, lse, g)
    chunked = attention_flash_bwd_reference(q, k, v, o, lse, g, chunk=100)
    for name, x, w in zip(("dq", "dk", "dv"), chunked, whole):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        assert _share(_flat(x), _flat(w)) <= BWD_TOL[dtype], name


def _jax_route(b, n, m, d, c, itemsize):
    """The JAX dispatch (pallas_attention.py:799-815 and :741-753) as a
    route name."""
    if pa._pick_block(n, m, d, c):
        return "single"
    assert pa._pick_flash_blocks(n, m, d, c)[0], "JAX would run the einsum"
    fbn, fbm = pa._pick_flash_blocks_bwd_fused(n, m, d, c, itemsize)
    if fbn and b * (m // fbm) * pa._sublanes(d) * n * 4 <= pa.DQ_SLAB_LIMIT:
        return "flash_fused"
    return "flash_two_kernel"


def _port_route(b, n, m, d, c, itemsize):
    if single_pass(m, d, c):
        return "single"
    return ("flash_fused" if flash_bwd_fused(b, n, m, d, c, itemsize)
            else "flash_two_kernel")


def _model_sites():
    """{(N, M, d, c)} of a vanilla G and D with attention at every map,
    at 32-512 px, gf = df in {8, 16}, with and without attn_downsample."""
    sites = set()
    for img in (32, 64, 128, 256, 512):
        sides = [s for s in (4, 8, 16, 32, 64, 128, 256, 512) if s <= img]
        for width in (8, 16):
            for down in (True, False):
                config = resolve_config({
                    "data_path": "unused", "model": "vanilla", "z_dim": 8,
                    "gf_dim": width, "df_dim": width, "img_size": img,
                    "use_attention": True, "attn_dim_G": sides,
                    "attn_dim_D": sides, "attn_downsample": down,
                    "batch_size": 1, "lr_g": 1e-4, "lr_d": 1e-4,
                    "compute_dtype": "float32"}, num_local_devices=1)
                for net in (get_generator(config),
                            get_discriminator(config)):
                    for name, mod in net.named_modules():
                        if isinstance(mod, SelfAttention):
                            side = int(name.removeprefix("attn"))
                            keys = (side // 2) ** 2 if down else side ** 2
                            sites.add((side * side, keys, mod.qk_dim,
                                       mod.v_dim))
    return sorted(sites)


# the model shapes with B <= 4 where the port's route is not the JAX
# dispatch's: the 512 map without attn_downsample in bf16 at B = 2 and 3,
# where the bf16 K6's 2,048-key block writes 536.9 and 805.3 MB of
# partials, inside DQ_SLAB_BUDGET, and the JAX package's fused backward
# (d padded to 8 sublanes) would pass DQ_SLAB_LIMIT
ROUTES_APART = {(2, 512 * 512, 512 * 512, 2, 8, 2),
                (3, 512 * 512, 512 * 512, 2, 8, 2)}


def test_routing_matches_jax_dispatch_at_every_model_shape():
    """The JAX dispatch's route at every model shape with B <= 4 whose
    widths the kernels take (the port's fused-backward rule is its own:
    it means to agree there), except at ``ROUTES_APART``, where the port
    takes K6 within its budget and the JAX package its two-kernel
    backward; past B = 4 the port's rule is the slab budget alone."""
    sites = _model_sites()
    assert (512 * 512, 256 * 256, 2, 8) in sites      # church512's G site
    assert (64 * 64, 32 * 32, 8, 32) in sites         # and its D site
    routes, compared, apart = set(), 0, set()
    for n, m, d, c in sites:
        taken = (d in cuda_attention.SUPPORTED_D
                 and c in cuda_attention.SUPPORTED_C)
        for b in (1, 2, 3, 4, 8, 64):
            for itemsize in (2, 4):
                got = _port_route(b, n, m, d, c, itemsize)
                routes.add(got)
                if b <= 4 and taken:
                    want = _jax_route(b, n, m, d, c, itemsize)
                    if (b, n, m, d, c, itemsize) in ROUTES_APART:
                        assert (got, want) == ("flash_fused",
                                               "flash_two_kernel")
                        assert pa.DQ_SLAB_LIMIT \
                            < b * (m // 2048) * 8 * n * 4
                        apart.add((b, n, m, d, c, itemsize))
                    else:
                        assert got == want, (b, n, m, d, c, itemsize, want)
                    compared += 1
                elif got != "single":
                    fits = dq_slab_bytes(b, n, m, d, c, itemsize) \
                        <= DQ_SLAB_BUDGET
                    assert got == ("flash_fused" if fits
                                   else "flash_two_kernel")
    assert apart == ROUTES_APART
    assert compared > 100
    assert routes == {"single", "flash_fused", "flash_two_kernel"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c", [(2, 8), (8, 16)])
def test_two_kernel_backward_past_the_slab_budget_matches_jax(d, c, dtype,
                                                              monkeypatch):
    """Both packages' slab budgets forced to 0 (``DQ_SLAB_LIMIT`` on the
    JAX module, ``DQ_SLAB_BUDGET`` on the port's, each package's own rule
    taking the fused backward at this shape otherwise): ``jax.vjp`` of the
    JAX flash op runs ``_flash_bwd`` (K4 + K5's TPU kernels, interpret
    mode) and ``FlashAttention`` runs ``attention_flash_dq_dkv`` (K4 + K5;
    the plain versions on the CPU); dq, dk and dv agree within
    ``VJP_TOL``."""
    b, n, m = 2, 256, 2048
    itemsize = 2 if dtype == "bfloat16" else 4
    assert pa._pick_flash_blocks_bwd_fused(n, m, d, c, itemsize)[0]
    assert flash_bwd_fused(b, n, m, d, c, itemsize)
    taken = []

    def spy(module, name):
        real = getattr(module, name)

        def call(*args, **kwargs):
            taken.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, call)

    for name in ("_flash_bwd", "_flash_bwd_fused"):
        spy(pa, name)
    for name in ("attention_flash_dq_dkv", "attention_flash_dqkv"):
        spy(cuda_attention, name)
    monkeypatch.setattr(pa, "DQ_SLAB_LIMIT", 0)
    monkeypatch.setattr(attention_ops, "DQ_SLAB_BUDGET", 0)

    arrays = _arrays(d, c, b=b, n=n, m=m, seed=9)
    bn, bm = pa._pick_flash_blocks(n, m, d, c)
    fbn, fbm = pa._pick_flash_blocks_fwd(n, m, d, c)
    jq, jk, jv, jg = _jax(arrays, dtype)
    _, vjp = jax.vjp(lambda q, k, v: pa._attention_flash(
        q, k, v, bn, bm, fbn, fbm, 1, True), jq, jk, jv)
    want = vjp(jg)
    q, k, v, g = _port(arrays, dtype)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(cuda_attention.FlashAttention.apply(*leaves),
                              leaves, g)
    assert taken == ["_flash_bwd", "attention_flash_dq_dkv"]
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == getattr(torch, dtype) and x.shape == w.shape, name
        assert _share(_flat(x), w) <= VJP_TOL[dtype], (name, _share(_flat(x),
                                                                    w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_two_kernel_backward_launches_delta_k4_and_k5(dtype, monkeypatch):
    """With the card's checks and launches stubbed out (CPU tensors stand
    in for CUDA ones) and ``flash_bwd_fused`` false, a ``FlashAttention``
    backward in bf16 launches the delta pass, the tensor-core K4 and K5,
    each once, both reading the scratch the delta pass wrote; in fp32 the
    CUDA-core K4 and K5, which take (o, lse) themselves."""
    launched = []
    monkeypatch.setattr(cuda_attention, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda_attention, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_attention, "_launch", lambda name, ts, *a: (
        launched.append((name, ts))))
    monkeypatch.setattr(cuda_attention, "_delta_rows",
                        lambda n, c: -(-n // 64) * 64)
    monkeypatch.setattr(cuda_attention, "flash_bwd_fused", lambda *a: False)
    counters = ("FLASH_DQ_MMA_LAUNCHES", "FLASH_DKV_MMA_LAUNCHES",
                "FLASH_DQ_LAUNCHES", "FLASH_DKV_LAUNCHES",
                "FLASH_DQKV_MMA_LAUNCHES", "FLASH_DQKV_LAUNCHES")
    before = [getattr(cuda_attention, name) for name in counters]
    q, k, v, g = _port(_arrays(2, 8, b=1, n=8, m=16), dtype)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = cuda_attention.FlashAttention.apply(*leaves)
    launched.clear()                     # the forward's launch
    grads = torch.autograd.grad(out, leaves, g)
    names = [name for name, _ in launched]
    moved = [getattr(cuda_attention, name) - x
             for name, x in zip(counters, before)]
    if dtype == "bfloat16":
        assert names == ["sagan_attention_flash_delta_mma",
                         "sagan_attention_flash_dq_mma",
                         "sagan_attention_flash_dkv_mma"]
        ld = launched[0][1][3]
        assert ld.shape == (1, 64, 2) and ld.dtype == torch.float32
        assert launched[1][1][4] is ld and launched[2][1][4] is ld
        assert moved == [1, 1, 0, 0, 0, 0]
        # scratch of another shape never reaches a kernel
        with pytest.raises(ValueError, match="ld must be"):
            cuda_attention.attention_flash_dq(
                *(t.detach() for t in leaves), torch.empty_like(g),
                torch.empty(1, 8, 1), g, ld=torch.empty(1, 8, 2))
        assert len(launched) == 3
    else:
        assert names == ["sagan_attention_flash_dq",
                         "sagan_attention_flash_dkv"]
        assert moved == [0, 0, 1, 1, 0, 0]
    assert [tuple(x.shape) for x in grads] == [(1, 8, 2), (1, 16, 2),
                                               (1, 16, 8)]


def test_church512_takes_k6_at_its_batch_and_k4_k5_past_it():
    """In bf16 K6 up to B = 12 at church512's 512 map (2,048 keys a block:
    805 MB, the budget's edge), K4 + K5 from B = 13; in fp32 (1,024 keys)
    K6 up to B = 6, K4 + K5 from B = 7."""
    n, m, d, c = 512 * 512, 256 * 256, 2, 8
    assert not single_pass(m, d, c) and single_pass(32 * 32, 8, 32)
    assert flash_bwd_fused(4, n, m, d, c, 2)
    assert flash_bwd_fused(4, n, m, d, c, 4)
    assert flash_bwd_fused(6, n, m, d, c, 2)
    assert flash_bwd_fused(6, n, m, d, c, 4)  # 805 MB: the edge
    assert not flash_bwd_fused(7, n, m, d, c, 4)
    assert flash_bwd_fused(8, n, m, d, c, 2)
    assert flash_bwd_fused(12, n, m, d, c, 2)  # 805 MB: the edge
    assert not flash_bwd_fused(13, n, m, d, c, 2)
    assert not flash_bwd_fused(8, n, m, d, c, 4)


@pytest.mark.parametrize("b,n,m,itemsize,nbytes,fused", [
    (4, 512 * 512, 256 * 256, 2, 268435456, True),    # church512, B = 4
    (4, 512 * 512, 256 * 256, 4, 536870912, True),
    (8, 512 * 512, 256 * 256, 2, 536870912, True),    # its B = 8 step
    (16, 256 * 256, 128 * 128, 2, 67108864, True),    # church256, B = 16
    (4, 512 * 512, 512 * 512, 2, 1073741824, False),  # past the budget
    (1, 512 * 512, 1000, 2, 2097152, True),           # one ragged block
    (16, 512 * 512, 256 * 256, 2, 1073741824, False),  # church512, B = 16
    (8, 512 * 512, 256 * 256, 4, 1073741824, False),  # its B = 8, fp32
], ids=["church512_b4", "church512_b4_fp32", "church512_b8", "church256",
        "past_budget", "ragged", "church512_b16", "church512_b8_fp32"])
def test_fused_backward_rule_counts_the_dq_slab(b, n, m, itemsize, nbytes,
                                                 fused):
    """[B, ceil(M / key block), N, d] fp32 at d = 2, c = 8, whose key block
    is 2,048 in bf16 (16 warps) and 1,024 in fp32; K6 up to
    DQ_SLAB_BUDGET (768 MiB)."""
    assert fused_keys_per_block(2, 8, itemsize) == (
        2048 if itemsize == 2 else 1024)
    assert dq_slab_bytes(b, n, m, 2, 8, itemsize) == nbytes
    assert flash_bwd_fused(b, n, m, 2, 8, itemsize) is fused
    assert DQ_SLAB_BUDGET == 768 * 1024 * 1024


@pytest.mark.parametrize("d,c,itemsize,keys", [
    (2, 8, 2, 2048), (8, 8, 2, 2048), (16, 8, 2, 1024), (2, 16, 2, 1024),
    (32, 8, 2, 256), (2, 32, 2, 512), (32, 128, 2, 128), (2, 128, 2, 256),
    (2, 8, 4, 1024), (4, 16, 4, 512), (32, 8, 4, 256), (8, 128, 4, 256),
])
def test_key_blocks_of_both_engines_set_the_partials_shape(d, c, itemsize,
                                                            keys):
    """The Python copy of each K6's key block (``attention_flash_mma.cu``
    k6_warps x 16 x key tiles, ``attention_flash_bwd.cu`` kThreads x KPT),
    which chip_smoke holds against the libraries: the bf16 K6 takes 16
    warps where d <= 16, twice K2's gradient pass's 8, and 8 at d = 32;
    ``dq_partial_shape`` at the shipped libraries needs no build."""
    assert fused_keys_per_block(d, c, itemsize) == keys
    if itemsize == 2:
        assert (k6_warps(d) == MMA_K6_WARPS) is (d <= 16)
        assert keys == k6_warps(d) * 16 * mma_key_tiles(d, c)
        assert keys == (2 if d <= 16 else 1) * MMA_BWD_WARPS * 16 \
            * mma_key_tiles(d, c)
    engine = "mma" if itemsize == 2 else "fma"
    assert cuda_attention.dq_partial_shape(3, 100, 3 * keys + 1, d, c,
                                           engine=engine) == (3, 4, 100, d)


@pytest.mark.parametrize("b,m,d,c,blocks", [
    (64, 1024, 2, 8, 4),     # church64 G's 64 map: 256 keys, 256 blocks
    (64, 256, 4, 16, 2),     # G's 32 map: 128 keys, the least
    (128, 16, 8, 32, 1),     # D's 8 map (fused D update)
    (64, 4, 16, 64, 1),      # D's 4 map
    (8, 1024, 8, 32, 8),     # church512 D's 64 map at B=8: KT 1 at last
    (128, 1024, 2, 8, 2),    # imagenet128_cond D's 64 map, fused D update
    (64, 1024, 4, 16, 4),    # imagenet128_cond G's 64 map
    (64, 256, 8, 32, 2),     # imagenet128_cond G's 32 map
    (1024, 1024, 2, 8, 1),   # a grid that fills the card at K6's block
    (8, 65536, 2, 8, 64),    # church512 G's 512 map at B = 8
])
def test_k2_key_blocks_fill_the_card_and_set_its_scratch(b, m, d, c, blocks,
                                                         monkeypatch):
    """The bf16 K2's gradient pass halves K6's 8-warp key block while the
    grid holds fewer than ``K2_FILL`` blocks an SM (132 SMs, the H100's),
    and keeps 8 warps where K6 takes 16 (d <= 16); its fp32 dq
    partials are [B, blocks, N, d] and its (-lse log2e, delta) scratch
    [B, N padded to 64, 2], both from ``torch.empty`` in the wrapper (the
    launch stubbed out: CPU tensors stand in for CUDA ones)."""
    block8 = MMA_BWD_WARPS * 16 * mma_key_tiles(d, c)
    assert k2_key_blocks(b, m, d, c, 132) == blocks
    assert k2_key_blocks(b, m, d, c, 132, fill=0) == -(-m // block8)
    assert fused_keys_per_block(d, c, 2) == (
        2 * block8 if d <= 16 else block8)
    keys = -(-m // blocks)
    assert b * blocks >= K2_FILL * 132 or keys <= 128
    assert keys <= block8

    shapes = []
    monkeypatch.setattr(cuda_attention, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda_attention, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_attention, "_launch", lambda name, ts, *a: (
        shapes.extend(tuple(t.shape) for t in ts[7:])))
    monkeypatch.setattr(cuda_attention, "_delta_rows",
                        lambda n, c: -(-n // 64) * 64)
    monkeypatch.setattr(cuda_attention, "bwd_mma_key_blocks",
                        lambda b, m, d, c, tiles: k2_key_blocks(b, m, d, c,
                                                                132))
    n = 100
    q, k, v, g = (torch.empty(s, dtype=torch.bfloat16) for s in (
        (b, n, d), (b, m, d), (b, m, c), (b, n, c)))
    cuda_attention.attention_bwd_fused(q, k, v, g)
    assert shapes == [(b, 128, 2), (b, blocks, n, d)]


def test_attention_sends_large_key_sets_through_flash_attention_on_cpu():
    counts = ("LAUNCHES", "BWD_LAUNCHES", "FLASH_FWD_LAUNCHES",
              "FLASH_DQ_LAUNCHES", "FLASH_DKV_LAUNCHES",
              "FLASH_DQKV_LAUNCHES")
    before = [getattr(cuda_attention, name) for name in counts]
    q, k, v, g = _port(_arrays(2, 8, b=1, n=8, m=6144, seed=4), "float32")
    q.requires_grad_()
    out = attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(out, attention_reference(q.detach(), k, v),
                               rtol=0, atol=1e-6)
    (dq,) = torch.autograd.grad(out, (q,), g)
    o, lse = attention_flash_reference(q.detach(), k, v)
    torch.testing.assert_close(
        dq, attention_flash_bwd_reference(q.detach(), k, v, o, lse, g)[0],
        rtol=0, atol=0)
    small = attention(q, k[:, :4096], v[:, :4096])
    assert type(small.grad_fn).__name__ == "FusedAttentionBackward"
    assert [getattr(cuda_attention, name) for name in counts] == before


@pytest.mark.parametrize("wrapper", ["attention_flash_fwd",
                                     "attention_flash_dq",
                                     "attention_flash_dkv",
                                     "attention_flash_dqkv"])
def test_flash_wrappers_refuse_tensors_off_cpu_and_cuda(wrapper):
    q, k = torch.empty(1, 4, 2, device="meta"), torch.empty(1, 2, 2,
                                                            device="meta")
    v, g = torch.empty(1, 2, 8, device="meta"), torch.empty(1, 4, 8,
                                                            device="meta")
    lse = torch.empty(1, 4, 1, device="meta")
    args = (q, k, v) if wrapper == "attention_flash_fwd" else \
        (q, k, v, g, lse, g)
    counter = {"attention_flash_fwd": "FLASH_FWD_LAUNCHES"}.get(
        wrapper, wrapper.replace("attention_flash_", "FLASH_").upper()
        + "_LAUNCHES")
    before = getattr(cuda_attention, counter)
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(cuda_attention, wrapper)(*args)
    assert getattr(cuda_attention, counter) == before


def test_church512_weights_carry_across_both_ways():
    """Every JAX church512 G and D variable maps to a port parameter or
    buffer of the same shape and nothing is left over; values (made with
    numpy at the shapes of a JAX init, traced without running it) go
    into the port's modules and back out unchanged."""
    config = load_config_file("example_configs/church512_attn.py")
    config.update(img_size=512, num_classes=1, compute_dtype="float32")
    rs = np.random.RandomState(6)
    for jax_net, port_net in ((jax_generator, get_generator),
                              (jax_discriminator, get_discriminator)):
        shapes = jax.eval_shape(jax_net(jax_resolve(
            config, num_local_devices=1)).init, jax.random.PRNGKey(0))
        flat = {name: rs.standard_normal(a.shape).astype(np.float32)
                for name, a in flat_from_jax_tree(jax.tree.map(
                    lambda s: np.zeros(s.shape, np.float32),
                    shapes)).items()}
        net = port_net(resolve_config(config, num_local_devices=1))
        net.load_state_dict(state_from_jax(flat, net))   # strict
        back = jax_flat_from_module(net)
        assert back.keys() == flat.keys()
        for name, arr in flat.items():
            np.testing.assert_array_equal(back[name], arr, err_msg=name)
    gen = get_generator(resolve_config(config, num_local_devices=1))
    disc = get_discriminator(resolve_config(config, num_local_devices=1))
    assert [(n, m.qk_dim, m.v_dim) for n, m in gen.named_modules()
            if isinstance(m, SelfAttention)] == [("attn512", 2, 8)]
    assert [(n, m.qk_dim, m.v_dim) for n, m in disc.named_modules()
            if isinstance(m, SelfAttention)] == [("attn64", 8, 32)]
    assert len(gen.blocks) == 7


def test_plain_chunk_keeps_one_logit_block_within_its_budget():
    # church512's G site at B=1 (serving with use_pallas=False): 4096 rows
    assert plain_chunk(1, 512 * 512, 256 * 256) == 4096
    assert plain_chunk(4, 512 * 512, 256 * 256) == 1024
    assert plain_chunk(64, 4096, 1024) is None        # church64: one block
    assert plain_chunk(1, 10, 1 << 30) == 1


def test_profile_names_tell_the_attention_kernels_apart():
    """The breakdown tools sum a profile's kernels by wrapper; the names
    as a profile shows them (demangled templates) must not overlap."""
    sig = "(float const*, float const*, float const*, float*, int, int)"
    kernels = {
        f"void (anonymous namespace)::{name}<float, 2, 8>{sig}": (ms, n)
        for name, ms, n in (
            ("attention_fwd_kernel", 1.0, 8),
            ("attention_fwd_mma_kernel", 0.4, 8),
            ("attention_bwd_dq_kernel", 2.0, 6),
            ("attention_bwd_dkv_kernel", 3.0, 6),
            ("attention_bwd_stats_mma_kernel", 0.6, 6),
            ("attention_bwd_grads_mma_kernel", 1.0, 6),
            ("attention_flash_fwd_kernel", 40.0, 4),
            ("attention_flash_dq_kernel", 50.0, 2),
            ("attention_flash_dkv_kernel", 60.0, 2),
            ("attention_flash_dqkv_kernel", 70.0, 2),
            ("attention_flash_fwd_mma_kernel", 16.0, 4),
            ("attention_flash_dq_mma_kernel", 20.0, 2),
            ("attention_flash_dq_delta_kernel", 1.0, 2),
            ("attention_flash_dkv_mma_kernel", 22.0, 2),
            ("attention_flash_dqkv_mma_kernel", 18.0, 2),
            ("attention_flash_delta_kernel", 2.0, 2))}
    # K2's dq sum takes no template arguments
    kernels["void (anonymous namespace)::attention_bwd_dq_sum_kernel(float "
            "const*, __nv_bfloat16*, int, int)"] = (0.2, 6)
    kernels["void at::native::elementwise_kernel<128, 2>"] = (9.0, 100)
    rows = attention_kernels(kernels, per=2)
    assert rows == {
        "K1 attention_fwd": {"ms": 0.5, "launches": 4},
        "K1 attention_fwd_mma": {"ms": 0.2, "launches": 4},
        "K2 attention_bwd": {"ms": 2.5, "launches": 3},
        "K2 attention_bwd_mma": {"ms": 0.9, "launches": 3},
        "K3 attention_flash_fwd": {"ms": 20.0, "launches": 2},
        "K3 attention_flash_fwd_mma": {"ms": 8.0, "launches": 2},
        "K4 attention_flash_dq": {"ms": 25.0, "launches": 1},
        "K4 attention_flash_dq_mma": {"ms": 10.5, "launches": 1},
        "K5 attention_flash_dkv": {"ms": 30.0, "launches": 1},
        "K5 attention_flash_dkv_mma": {"ms": 11.0, "launches": 1},
        "K6 attention_flash_dqkv": {"ms": 35.0, "launches": 1},
        "K6 attention_flash_dqkv_mma": {"ms": 10.0, "launches": 1}}


def test_cpu_flash_wrappers_run_the_plain_versions_in_chunks(monkeypatch):
    """On the CPU the wrappers take the plain versions a chunk of query
    rows at a time, as church512's 512 map needs (68 GB of logits at
    B=1 otherwise); the results are those of the unchunked versions,
    within the fp32 tolerances (the CPU's products of 10 rows and of 64
    may round apart)."""
    q, k, v, g = _port(_arrays(2, 8, b=1, n=64, m=3000, seed=7), "float32")
    assert cuda_attention._cpu_chunk(q, k) is None
    monkeypatch.setattr(attention_ops, "PLAIN_CHUNK_BYTES", 4 * 3000 * 10)
    assert cuda_attention._cpu_chunk(q, k) == 10
    o, lse = cuda_attention.attention_flash_fwd(q, k, v)
    want_o, want_lse = attention_flash_reference(q, k, v)
    for x, w in ((o, want_o), (lse, want_lse)):
        assert _share(_flat(x), _flat(w)) <= FWD_TOL["float32"]
    got = cuda_attention.attention_flash_dqkv(q, k, v, o, lse, g)
    want = attention_flash_bwd_reference(q, k, v, o, lse, g)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert _share(_flat(x), _flat(w)) <= BWD_TOL["float32"], name


def test_plain_flash_dq_is_near_float64_past_one_key_block():
    """The plain backward sums dq one ``PLAIN_KEY_BLOCK`` of keys at a
    time; against float64 arithmetic on the same fp32 inputs (rows with
    large |q| attend to few keys) it stays within 1e-5 of max|dq|."""
    q, k, v, g = _port(_arrays(2, 8, b=1, n=32, m=4 * PLAIN_KEY_BLOCK,
                               seed=8), "float32")
    q = q * 3
    o, lse = attention_flash_reference(q, k, v)
    dq = attention_flash_bwd_reference(q, k, v, o, lse, g)[0]
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    p = torch.exp(qd @ kd.transpose(1, 2) - lse.double())
    delta = (gd * o.double()).sum(-1, keepdim=True)
    want = (p * (gd @ vd.transpose(1, 2) - delta)) @ kd
    assert _share(_flat(dq), want.numpy()) <= 1e-5


ENGINE_COUNTERS = ("LAUNCHES", "BWD_LAUNCHES", "FWD_MMA_LAUNCHES",
                   "BWD_MMA_LAUNCHES", "FLASH_FWD_LAUNCHES",
                   "FLASH_DQ_LAUNCHES", "FLASH_DKV_LAUNCHES",
                   "FLASH_DQKV_LAUNCHES", "FLASH_FWD_MMA_LAUNCHES",
                   "FLASH_DQ_MMA_LAUNCHES", "FLASH_DKV_MMA_LAUNCHES",
                   "FLASH_DQKV_MMA_LAUNCHES")


def _engine_counts():
    return [getattr(cuda_attention, name) for name in ENGINE_COUNTERS]


def _wrapper_args(wrapper, q, k, v, g):
    """The arguments of each wrapper that takes an engine."""
    if wrapper in ("attention_fused", "attention_flash_fwd"):
        return q, k, v
    if wrapper == "attention_bwd_fused":
        return q, k, v, g
    o, lse = attention_flash_reference(q, k, v)
    return q, k, v, o, lse, g


@pytest.mark.parametrize("wrapper", ["attention_fused", "attention_bwd_fused",
                                     "attention_flash_fwd",
                                     "attention_flash_dq",
                                     "attention_flash_dkv",
                                     "attention_flash_dqkv"])
@pytest.mark.parametrize("engine", ["mma", "fma"])
def test_flash_wrappers_refuse_an_engine_on_cpu_tensors(wrapper, engine):
    """An engine names a CUDA kernel; CPU tensors run the plain version,
    so naming one there raises, and nothing is counted (every wrapper of
    K1-K6 takes an engine)."""
    q, k, v, g = _port(_arrays(2, 8, b=1, n=8, m=16), "bfloat16")
    args = _wrapper_args(wrapper, q, k, v, g)
    before = _engine_counts()
    getattr(cuda_attention, wrapper)(*args)          # the plain version
    with pytest.raises(ValueError, match="CPU tensors"):
        getattr(cuda_attention, wrapper)(*args, engine=engine)
    assert before == _engine_counts()


# each wrapper that takes an engine: (the C entries a call launches on its
# mma engine, on its fma engine, the counters they move); the mma K4 and K5
# called alone run the delta pass first
ENGINE_ENTRIES = {
    "attention_fused": (("sagan_attention_fwd_mma",),
                        ("sagan_attention_fwd",),
                        "FWD_MMA_LAUNCHES", "LAUNCHES"),
    "attention_bwd_fused": (("sagan_attention_bwd_mma",),
                            ("sagan_attention_bwd",),
                            "BWD_MMA_LAUNCHES", "BWD_LAUNCHES"),
    "attention_flash_fwd": (("sagan_attention_flash_fwd_mma",),
                            ("sagan_attention_flash_fwd",),
                            "FLASH_FWD_MMA_LAUNCHES", "FLASH_FWD_LAUNCHES"),
    "attention_flash_dq": (("sagan_attention_flash_delta_mma",
                            "sagan_attention_flash_dq_mma"),
                           ("sagan_attention_flash_dq",),
                           "FLASH_DQ_MMA_LAUNCHES", "FLASH_DQ_LAUNCHES"),
    "attention_flash_dkv": (("sagan_attention_flash_delta_mma",
                             "sagan_attention_flash_dkv_mma"),
                            ("sagan_attention_flash_dkv",),
                            "FLASH_DKV_MMA_LAUNCHES", "FLASH_DKV_LAUNCHES"),
    "attention_flash_dqkv_partials": (
        ("sagan_attention_flash_dqkv_mma",), ("sagan_attention_flash_dqkv",),
        "FLASH_DQKV_MMA_LAUNCHES", "FLASH_DQKV_LAUNCHES"),
}


@pytest.mark.parametrize("wrapper", sorted(ENGINE_ENTRIES))
def test_the_dtype_picks_the_engine_and_mma_refuses_fp32(wrapper,
                                                         monkeypatch):
    """The rule itself, then each wrapper through it: with the card's
    checks and launch stubbed out (CPU tensors stand in for CUDA ones), a
    bf16 call launches the mma entries, an fp32 or ``engine="fma"`` call
    the fma one, and ``engine="mma"`` on fp32 raises before any launch."""
    bf16 = torch.empty(1, 4, 2, dtype=torch.bfloat16)
    fp32 = torch.empty(1, 4, 2)
    pick = cuda_attention._engine
    assert pick(bf16, None, ()) == "mma"
    assert pick(fp32, None, ()) == "fma"
    assert pick(bf16, "fma", ()) == "fma"
    assert pick(bf16, None, ("-DSAGAN_FWD_ROWS=128",)) == "fma"
    assert pick(bf16, "mma", ("-DSAGAN_MMA_STAGES=1",)) == "mma"
    with pytest.raises(TypeError, match="bf16"):
        pick(fp32, "mma", ())
    with pytest.raises(ValueError, match="unknown engine"):
        pick(bf16, "wgmma", ())

    launched = []
    monkeypatch.setattr(cuda_attention, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda_attention, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_attention, "_launch",
                        lambda name, *a, **kw: launched.append(name))
    monkeypatch.setattr(cuda_attention, "_delta_rows",
                        lambda n, c, tiles=(): 64)
    monkeypatch.setattr(cuda_attention, "bwd_mma_key_blocks",
                        lambda *a: 1)
    mma, fma, mma_count, fma_count = ENGINE_ENTRIES[wrapper]
    fn = getattr(cuda_attention, wrapper)
    for dtype, engine, entry, counter in (
            ("bfloat16", None, mma, mma_count),
            ("float32", None, fma, fma_count),
            ("bfloat16", "fma", fma, fma_count)):
        q, k, v, g = _port(_arrays(2, 8, b=1, n=8, m=16), dtype)
        before = getattr(cuda_attention, counter)
        fn(*_wrapper_args(wrapper, q, k, v, g), engine=engine)
        assert tuple(launched) == entry
        launched.clear()
        assert getattr(cuda_attention, counter) == before + 1
    q, k, v, g = _port(_arrays(2, 8, b=1, n=8, m=16), "float32")
    with pytest.raises(TypeError, match="bf16"):
        fn(*_wrapper_args(wrapper, q, k, v, g), engine="mma")
    assert launched == []
