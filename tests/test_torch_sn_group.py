"""The grouped spectral norm K7 of the port (``ops/cuda_spectral.py``: the
plain versions that a group runs on the CPU weight by weight, the
``SpectralNormGroup`` autograd Function, the plan that places a table's
work and outputs) and its routing (``nn/layers.py`` ``set_sn_backend``: one
grouped call a forward of a net, each layer taking its W̄ once) against
the JAX package on the same numpy-seeded inputs: ``_sn_call`` in interpret
mode, ``_sn_fwd`` / ``_sn_bwd`` through ``jax.vjp``, and the resnet family
with ``set_sn_backend(..., "pallas", interpret=True)``.

Tolerances: W̄, u, v and sigma within 1e-5 (the same fp32
multiply-and-reduce in another summation order); gradients within 1e-4
(the closed form on both sides, ⟨g, W⟩ summed in another order); G's tanh
output 1e-5 and D's scores 1e-4 absolute, as ``tests/test_torch_resnet.py``
holds the resnet family."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sagan_tpu.models import get_discriminator as jax_discriminator
from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.nn.layers import set_sn_backend as jax_set_sn_backend
from sagan_tpu.ops.pallas_spectral import _sn_call, _sn_fused
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu_torch.convert import (flat_from_jax_tree, jax_flat_from_module,
                                     state_from_jax)
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.nn import layers as tlayers
from sagan_tpu_torch.ops import cuda_spectral
from sagan_tpu_torch.ops.cuda_spectral import (MAX_WEIGHTS, PLAN_FIELDS,
                                               group_plan, sn_group_backward,
                                               sn_group_forward, split_stats,
                                               spectral_norm_group,
                                               spectral_norm_reference)
from sagan_tpu_torch.train.trainer import build_train_step
from sagan_tpu_torch.utils.config import (load_config_file,
                                          resolve_config)

TOL = 1e-5
GRAD_TOL = 1e-4
G_TOL = 1e-5
D_TOL = 1e-4
EPS = 1e-12

# a mixed table: (JAX shape, permutation JAX -> port, the port's out_dim):
# Dense and Embedding [in, out], Conv HWIO -> OIHW, ConvT HWIO -> IOHW, a
# Dense head with O = 1 and a slab layout of R >= 32
TABLE = (((24, 10), (0, 1), -1),
         ((7, 12), (0, 1), -1),
         ((3, 3, 6, 10), (3, 2, 0, 1), 0),
         ((1, 1, 16, 2), (3, 2, 0, 1), 0),
         ((3, 3, 6, 10), (2, 3, 0, 1), 1),
         ((40, 1), (0, 1), -1),
         ((3, 3, 8, 5), (3, 2, 0, 1), 0))
N_ITERS = {"1": [1] * len(TABLE), "2": [2] * len(TABLE),
           "mixed": [1 + i % 2 for i in range(len(TABLE))]}

# the resnet family at 32 px, conditional (as tests/test_torch_resnet.py)
SMALL = {
    "dataset": "synthetic", "data_path": "unused", "model": "resnet",
    "z_dim": 8, "gf_dim": 8, "df_dim": 8, "img_size": 32,
    "use_attention": True, "attn_dim_G": [16], "attn_dim_D": [8],
    "num_classes": 4, "batch_size": 4, "num_devices": 1, "lr_g": 1e-4,
    "lr_d": 4e-4, "compute_dtype": "float32", "use_label": True,
    "use_cond_bn": True,
}


def _table(seed):
    """Numpy-seeded weights (JAX layout) and unit u's of TABLE."""
    rs = np.random.RandomState(seed)
    ws, us = [], []
    for shape, _, _ in TABLE:
        ws.append(rs.randn(*shape).astype(np.float32))
        u = rs.randn(shape[-1]).astype(np.float32)
        us.append(u / np.linalg.norm(u))
    return ws, us


def _port(w, perm):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))


def _jax(t, perm):
    return t.detach().float().numpy().transpose(np.argsort(perm))


def _jax_v(v, shape):
    """JAX's v over HWIO rows (h, w, i) in the port's fan-in order."""
    v = np.asarray(v)[:, 0]
    if len(shape) == 4:
        v = v.reshape(shape[:3]).transpose(2, 0, 1).reshape(-1)
    return v


@pytest.mark.parametrize("iters", sorted(N_ITERS))
def test_plain_group_matches_the_jax_kernel_weight_by_weight(iters):
    """One group over the mixed table against ``_sn_call`` per weight:
    W̄, u_new, v and sigma; u stored into the weights asked for, and only
    those."""
    n_iters = N_ITERS[iters]
    ws, us = _table(seed=len(iters))
    tws = [_port(w, perm) for w, (_, perm, _) in zip(ws, TABLE)]
    tus = [torch.from_numpy(u.copy()) for u in us]
    out_dims = [d for _, _, d in TABLE]
    store = [i % 3 == 0 for i in range(len(TABLE))]
    w_bars, stats = sn_group_forward(tws, tus, n_iters, out_dims, EPS,
                                     store=store)
    parts = split_stats(stats, group_plan(tws, n_iters, out_dims))
    for i, ((shape, perm, _), w, u) in enumerate(zip(TABLE, ws, us)):
        jw, ju, jv, js = _sn_call(jnp.asarray(w.reshape(-1, shape[-1])),
                                  jnp.asarray(u)[None, :], n_iters[i], EPS,
                                  interpret=True)
        u_new, v, sigma = parts[i]
        np.testing.assert_allclose(_jax(w_bars[i], perm),
                                   np.asarray(jw).reshape(shape), atol=TOL,
                                   rtol=TOL, err_msg=f"w_bar {i}")
        np.testing.assert_allclose(u_new.numpy(), np.asarray(ju)[0],
                                   atol=TOL, err_msg=f"u {i}")
        np.testing.assert_allclose(v.numpy(), _jax_v(jv, shape), atol=TOL,
                                   err_msg=f"v {i}")
        np.testing.assert_allclose(float(sigma), float(np.asarray(js)[0, 0]),
                                   rtol=TOL, err_msg=f"sigma {i}")
        want_u = u_new.numpy() if store[i] else us[i]
        np.testing.assert_array_equal(tus[i].numpy(), want_u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_group_backward_matches_jax_vjp(n_iter, dtype):
    """dW of every weight through ``SpectralNormGroup`` against
    ``jax.vjp`` of the JAX fused SN (``_sn_fwd`` / ``_sn_bwd``) on the
    same cotangents (rounded to W̄'s dtype); the weight whose W̄ takes no
    gradient gets none."""
    ws, us = _table(seed=10 + n_iter)
    rs = np.random.RandomState(n_iter)
    skip = 2
    leaves = [_port(w, perm).requires_grad_()
              for w, (_, perm, _) in zip(ws, TABLE)]
    w_bars = spectral_norm_group(
        leaves, [torch.from_numpy(u) for u in us], [n_iter] * len(TABLE),
        [d for _, _, d in TABLE], EPS, dtypes=[dtype] * len(TABLE))
    assert all(b.dtype == dtype for b in w_bars)
    gs = [torch.from_numpy(rs.randn(*b.shape).astype(np.float32)).to(dtype)
          for b in w_bars]
    keep = [i for i in range(len(TABLE)) if i != skip]
    got = torch.autograd.grad([w_bars[i] for i in keep],
                              leaves, [gs[i] for i in keep],
                              allow_unused=True)
    assert got[skip] is None
    for i in keep:
        shape, perm, _ = TABLE[i]
        w_mat = jnp.asarray(ws[i].reshape(-1, shape[-1]))
        _, vjp = jax.vjp(
            lambda w: _sn_fused(w, jnp.asarray(us[i])[None, :], n_iter,
                                EPS, True)[0], w_mat)
        g = _jax(gs[i], perm).reshape(-1, shape[-1])
        want = np.asarray(vjp(jnp.asarray(g))[0]).reshape(shape)
        assert got[i].dtype == torch.float32
        np.testing.assert_allclose(_jax(got[i], perm), want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"dW {i}")


def _small_pair(net):
    """The port's and the JAX small resnet ``net`` ("G" or "D") on one set
    of perturbed JAX weights, both routed to K7 (the port's plain version,
    JAX's fused SN in interpret mode)."""
    build = {"G": (jax_generator, get_generator),
             "D": (jax_discriminator, get_discriminator)}[net]
    jnet = build[0](jax_resolve(SMALL, num_local_devices=1))
    jax_set_sn_backend(jnet, "pallas", interpret=True)
    variables = jnet.init(jax.random.PRNGKey(5))
    rs = np.random.RandomState(6)
    flat = {}
    for name, a in flat_from_jax_tree(variables).items():
        a = np.asarray(a, np.float32)
        if name.endswith("/var"):
            a = rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
        elif name.endswith(("/mean", "/gamma", "/beta", "/b")):
            a = a + 0.2 * rs.randn(*a.shape).astype(np.float32)
        elif name.endswith("/sigma"):
            a = np.full(a.shape, 0.7, np.float32)
        flat[name] = a
    port = build[1](resolve_config({**SMALL, "use_pallas_sn": True},
                                   num_local_devices=1))
    port.load_state_dict(state_from_jax(flat, port))
    tree = jax.tree.map(jnp.asarray, variables)
    tree = {"params": _unflat(flat, "params", tree["params"]),
            "aux": _unflat(flat, "aux", tree["aux"])}
    return jnet, tree, port


def _unflat(flat, section, like):
    """``like`` (a JAX variable tree section) with the leaves of ``flat``."""
    paths = jax.tree_util.tree_flatten_with_path(like)[0]
    treedef = jax.tree_util.tree_structure(like)
    leaves = [jnp.asarray(flat[section + "/" + "/".join(
        str(getattr(k, "key", k)) for k in path)]) for path, _ in paths]
    return jax.tree.unflatten(treedef, leaves)


@pytest.mark.parametrize("net", ["G", "D"])
def test_small_resnet_with_k7_matches_jax_and_moves_u_in_training_only(net):
    """An eval-mode forward leaves every u alone and a training-mode
    forward stores JAX's; outputs agree in both modes."""
    jnet, tree, port = _small_pair(net)
    rs = np.random.RandomState(7)
    labels = rs.randint(0, 4, 3)
    if net == "G":
        x = rs.randn(3, 8).astype(np.float32)
        tx, layout, tol = torch.from_numpy(x), (0, 2, 3, 1), G_TOL
    else:
        x = rs.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
        tx, layout, tol = (torch.from_numpy(x).permute(0, 3, 1, 2), None,
                           D_TOL)
    before = {k: v.clone() for k, v in port.state_dict().items()
              if k.endswith(".u")}
    assert len(before) == len(port._sn_group) > 0
    for train in (False, True):
        want, aux = jnet(tree, jnp.asarray(x), jnp.asarray(labels),
                         train=train)
        port.train(train)
        with torch.no_grad():
            got = port(tx, torch.from_numpy(labels))
        if layout is not None:
            got = got.permute(*layout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0, err_msg=f"train={train}")
        state = port.state_dict()
        if not train:
            for k, u in before.items():
                assert torch.equal(state[k], u), k
        else:
            got_aux = jax_flat_from_module(port)
            for name, value in flat_from_jax_tree({"aux": aux}).items():
                if name.endswith("/u"):
                    np.testing.assert_allclose(got_aux[name], value,
                                               atol=TOL, err_msg=name)
                    if value.size > 1:   # a u of one element stays 1
                        assert not np.array_equal(value, before[
                            name[len("aux/"):-2].replace("/", ".") + ".u"]
                            .numpy()), name


def test_unfused_d_update_moves_u_twice_as_jax_does():
    """With ``fuse_d_batches`` off the D update runs D twice, so each
    forward's grouped call moves u (two calls, as JAX threads its aux
    through two applies); the loss's gradients flow through both."""
    jdisc, tree, disc = _small_pair("D")
    config = resolve_config({**SMALL, "use_pallas_sn": True,
                             "fuse_d_batches": False}, num_local_devices=1)
    step = build_train_step(config, lambda i: 1e-4, lambda i: 4e-4,
                            get_generator(config), disc)
    rs = np.random.RandomState(8)
    real = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    fake = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lr, lf = rs.randint(0, 4, 2), rs.randint(0, 4, 2)
    disc.train()
    params = [p for _, p in disc.named_parameters()]
    loss, _ = step._d_loss(disc, torch.from_numpy(real).permute(0, 3, 1, 2),
                           torch.from_numpy(lr),
                           torch.from_numpy(fake).permute(0, 3, 1, 2),
                           torch.from_numpy(lf))
    grads = dict(zip([n for n, _ in disc.named_parameters()],
                     torch.autograd.grad(loss, params)))

    def jax_loss(params_d):
        out_r, aux1 = jdisc({"params": params_d, "aux": tree["aux"]},
                            jnp.asarray(real), jnp.asarray(lr), train=True)
        out_f, aux2 = jdisc({"params": params_d, "aux": aux1},
                            jnp.asarray(fake), jnp.asarray(lf), train=True)
        loss = (jnp.mean(jax.nn.relu(1.0 - out_r))
                + jnp.mean(jax.nn.relu(1.0 + out_f)))
        return loss, (aux1, aux2)

    (want_loss, (aux1, aux2)), jgrads = jax.value_and_grad(
        jax_loss, has_aux=True)(tree["params"])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_aux = jax_flat_from_module(disc)
    once = flat_from_jax_tree({"aux": aux1})
    for name, value in flat_from_jax_tree({"aux": aux2}).items():
        if name.endswith("/u"):
            np.testing.assert_allclose(got_aux[name], value, atol=TOL,
                                       err_msg=name)
            if value.size > 1:
                assert np.abs(value - once[name]).max() > 0, name
    # the gradients in JAX's layout: a copy of D holding them as weights
    holder = copy.deepcopy(disc)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(grads[name])
    got = jax_flat_from_module(holder)
    for name, value in flat_from_jax_tree({"params": jgrads}).items():
        np.testing.assert_allclose(got[name], np.asarray(value),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


class _TwoLayers(nn.Module):
    """Two SN layers; ``mode`` "both" calls each once, "skip" the first
    only, "twice" the first twice."""

    def __init__(self):
        super().__init__()
        rng = torch.Generator().manual_seed(0)
        self.a = tlayers.Dense(4, 4, sn=True, rng=rng)
        self.b = tlayers.Dense(4, 3, sn=True, rng=rng)
        self.mode = "both"

    def forward(self, x):
        h = self.a(x)
        if self.mode == "twice":
            h = self.a(h)
        return h if self.mode == "skip" else self.b(h)


@pytest.mark.parametrize("mode,message", [("skip", "took no part"),
                                          ("twice", "called twice")])
def test_a_layer_skipped_or_called_twice_in_a_grouped_forward_raises(
        mode, message):
    net = _TwoLayers()
    tlayers.set_sn_backend(net, "pallas")
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    net.mode = mode
    with pytest.raises(RuntimeError, match=message):
        net(x)
    net.mode = "both"
    u = net.b.u.clone()
    assert net(x).shape == (2, 3)                 # the next forward is whole
    assert not torch.equal(net.b.u, u)            # and moved b's u once
    # a layer called on its own, outside its root's forward: a group of one
    assert net.a(x).shape == (2, 4)


def test_xla_on_a_deep_copy_removes_the_group_hooks():
    """``deepcopy`` carries the hooks, which then serve the copy's own
    layers; ``set_sn_backend(copy, "xla")`` takes them off the copy and
    leaves the original's."""
    net = _TwoLayers()
    tlayers.set_sn_backend(net, "pallas")
    twin = copy.deepcopy(net)
    assert twin._sn_group == [twin.a, twin.b]
    assert len(twin._forward_pre_hooks) == len(twin._forward_hooks) == 1
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(2))
    u = net.a.u.clone()
    twin(x)
    assert torch.equal(net.a.u, u) and not torch.equal(twin.a.u, u)
    tlayers.set_sn_backend(twin, "xla")
    assert not twin._forward_pre_hooks and not twin._forward_hooks
    assert "_sn_group" not in twin.__dict__
    assert {m.sn_backend for m in (twin.a, twin.b)} == {"xla"}
    assert len(net._forward_pre_hooks) == len(net._forward_hooks) == 1
    twin.load_state_dict(net.state_dict())
    torch.testing.assert_close(twin.eval()(x), net.eval()(x), atol=TOL,
                               rtol=0)


def test_cpu_path_counts_no_launch():
    """A K7-routed resnet G forward and backward on the CPU runs the
    plain versions: no grouped call, weight or backward is counted."""
    gen = get_generator(resolve_config({**SMALL, "use_pallas_sn": True},
                                       num_local_devices=1))
    gen.train()
    before = (cuda_spectral.LAUNCHES, cuda_spectral.WEIGHTS,
              cuda_spectral.BWD_LAUNCHES)
    rng = torch.Generator().manual_seed(3)
    out = gen(torch.randn(2, 8, generator=rng), torch.tensor([0, 3]))
    grads = torch.autograd.grad(out.square().sum(), list(gen.parameters()))
    assert all(g is not None for g in grads)
    assert (cuda_spectral.LAUNCHES, cuda_spectral.WEIGHTS,
            cuda_spectral.BWD_LAUNCHES) == before


@pytest.mark.parametrize("net", ["G", "D"])
def test_imagenet128_tables_fit_one_call_and_plan_every_tile_once(net):
    """imagenet128_cond's G (25 SN weights) and D (28) each fit one
    grouped call; the plan covers every tile and element once, largest
    weight first, with aligned, disjoint outputs."""
    config = load_config_file("example_configs/imagenet128_cond.py")
    config.update(img_size=128, num_classes=1000, compute_dtype="bfloat16",
                  use_pallas_sn=True)
    config = resolve_config(config, num_local_devices=1)
    with torch.device("meta"):
        model = (get_generator if net == "G" else get_discriminator)(config)
    group = model._sn_group
    assert len(group) == {"G": 25, "D": 28}[net] <= MAX_WEIGHTS
    ws = [m.w for m in group]
    plan = group_plan(ws, [1] * len(ws), [m.out_dim for m in group])
    rows = [dict(zip(PLAN_FIELDS, plan.rows[k * len(PLAN_FIELDS):
                                            (k + 1) * len(PLAN_FIELDS)]))
            for k in range(len(ws))]
    sizes = [r["A"] * r["O"] * r["R"] for r in rows]
    assert sizes == sorted(sizes, reverse=True)
    starts = {"item0": "items", "chunk0": "chunks"}
    for start, count in starts.items():
        assert [r[start] for r in rows] == list(np.cumsum(
            [0] + [r[count] for r in rows])[:-1])
    assert plan.rows_items == sum(r["items"] for r in rows)
    assert plan.col_blocks == sum(-(-r["O"] // 32) for r in rows)
    for r, size in zip(rows, sizes):
        assert (r["items"] - 1) * r["per_item"] < r["ntiles"] \
            <= r["items"] * r["per_item"]
        assert r["ntiles"] == -(-r["A"] // r["ta"]) * -(-r["R"] // r["tr"])
        assert r["chunk"] % 1024 == 0
        assert (r["chunks"] - 1) * r["chunk"] < size <= r["chunks"] * r["chunk"]
        assert r["flags"] & 1                    # every tile in shared memory
    assert plan.smem <= 200 * 1024
    spans = sorted((off, off + w.numel())
                   for off, w in zip(plan.flat_offs, ws))
    assert all(off % 64 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.flat


def test_group_splits_by_dtype_and_by_runs_of_max_weights(monkeypatch):
    """70 weights of two dtypes: one grouped forward for each dtype and
    each run of MAX_WEIGHTS, every W̄ that weight's plain one in its
    dtype, in the caller's order."""
    calls = []
    forward = cuda_spectral.sn_group_forward

    def counted(ws, *args, **kwargs):
        calls.append((len(ws), args[4]))
        return forward(ws, *args, **kwargs)

    monkeypatch.setattr(cuda_spectral, "sn_group_forward", counted)
    rng = torch.Generator().manual_seed(4)
    ws = [torch.randn(3 + i % 5, 2 + i % 3, generator=rng)
          for i in range(70)]
    us = [torch.randn(w.shape[-1], generator=rng) for w in ws]
    dtypes = [torch.bfloat16 if i % 7 == 0 else torch.float32
              for i in range(70)]
    w_bars = spectral_norm_group(ws, us, [1] * 70, [-1] * 70, EPS,
                                 dtypes=dtypes)
    assert sorted(calls, key=str) == sorted(
        [(32, torch.float32), (28, torch.float32), (10, torch.bfloat16)],
        key=str)
    for w, u, dtype, w_bar in zip(ws, us, dtypes, w_bars):
        want = spectral_norm_reference(w, u, 1, EPS, -1)[0].to(dtype)
        assert w_bar.dtype == dtype and torch.equal(w_bar, want)
