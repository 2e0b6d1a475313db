"""Core layers with inline spectral normalization, the SN embedding, and
(conditional) BatchNorm in training and eval mode: port of
``sagan_tpu/nn/layers.py``.

Layouts: activations NCHW; Dense weights ``[in, out]`` (as in JAX), conv
weights OIHW, transposed-conv weights IOHW (``F.conv_transpose2d``'s
layout).  Parameters and norm statistics are fp32; products run in the
layer's ``dtype``.  Names of parameters and buffers follow the JAX
variable tree, so ``params/<path>/w`` is the state-dict key ``<path>.w``
and ``aux/<path>/u`` the buffer ``<path>.u`` (``convert.py``).

Spectral normalization runs ``sn_iters`` power iterations from the stored
``u`` on every call of a layer; only a module in training mode stores the
new ``u`` (``sagan_tpu/nn/layers.py:33-46``).  :func:`set_sn_backend`
routes every SN layer of a model through K7 (``"pallas"``): one grouped
call at the start of each forward of the model normalizes all its SN
weights and hands each layer its W̄, which the layer takes exactly once
in that forward.

:func:`remat` runs a stage of a model under non-reentrant
``torch.utils.checkpoint``, which recomputes the stage in the backward.
JAX's ``remat_span`` records a stage's aux updates once, in the forward;
here the recompute calls the stage's modules a second time, so it runs
under a replay flag in which BN writes no buffer and each SN layer
returns the very W̄ its forward used (kept for the checkpoint's
recompute) and stores no u: state moves once per forward, and the
recompute's W̄ is the forward's.

:func:`bn_accum_begin` / :func:`bn_accum_finalize` give gradient
accumulation exact BN statistics (``sagan_tpu/nn/layers.py:273-330``):
between them each BN adds its batch (mean, E[x²]) into its buffers, and
finalize applies the momentum once to the micro-batches' average.

Under a ``torch.distributed`` group BN is cross-replica: E[x] and E[x²]
are averaged over the ranks of the data group (the world without model
parallelism; ``parallel.mesh.all_reduce_mean_grad``, one all-reduce a
layer) before the variance, as JAX's ``_batch_moments`` pmeans them, so
the running stats move by the global batch's moments on every rank and
the gradient is the global batch's.

Model parallelism (``parallel/sharding.py`` marks a layer ``sharded``): a
sharded layer holds this model rank's columns of its weight (and of
conditional BN's tables), computes those output channels from its whole
input and gathers them over the model group (``mesh.to_shards`` on the
way in, ``mesh.gather_shards`` on the way out); its bias is whole and is
added after the gather, and its SN is that of the whole weight
(``ops/spectral.py``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.cuda_spectral import spectral_norm_group
from ..ops.spectral import spectral_normalize
from ..parallel import mesh
from ..utils.profiling import span
from . import initializers as init

BN_EPS = 1e-3  # Keras BatchNormalization's default, as in the JAX layers
BN_MOMENTUM = 0.99


# what a layer holds in ``_sn_w_bar`` once it has taken its handed W̄
_TAKEN = object()


class _RematState(threading.local):
    """The checkpointed stage running on this thread: ``store`` maps each
    SN layer of its forward to the W̄ it used; ``replay`` is set while the
    backward recomputes the stage (on the autograd engine's thread)."""
    store: dict | None = None
    replay = False


_REMAT = _RematState()


@contextlib.contextmanager
def _remat_mode(store: dict, replay: bool):
    saved = _REMAT.store, _REMAT.replay
    _REMAT.store, _REMAT.replay = store, replay
    try:
        yield
    finally:
        _REMAT.store, _REMAT.replay = saved


def _keep(t):
    return t


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept (``torch.utils.checkpoint``, non-reentrant), BN and SN
    state moving once (see the module docstring).  The stages draw no
    random numbers, so the RNG state is not saved for the recompute."""
    store: dict = {}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (_remat_mode(store, False),
                                          _remat_mode(store, True)))


class _SNLayer(nn.Module):
    """A layer with weight ``w`` and, when ``sn``, its SN vector ``u``
    over the output-channel axis ``out_dim`` of ``w``."""

    out_dim = -1
    sn_backend = "xla"   # or "pallas" (K7), set by set_sn_backend
    _sn_w_bar = None     # W̄ handed over by its root's grouped K7 call
    sharded = False      # w holds this model rank's output channels

    def __init__(self, w_shape, cout, use_bias, sn, sn_iters, dtype, rng,
                 w_init=init.glorot_uniform):
        super().__init__()
        self.sn, self.sn_iters, self.dtype = sn, sn_iters, dtype
        self.w = nn.Parameter(w_init(w_shape, rng))
        self.b = nn.Parameter(init.zeros((cout,))) if use_bias else None
        if sn:
            self.register_buffer("u", init.l2_normal((cout,), rng))

    def weight(self) -> torch.Tensor:
        """The kernel this call uses, spectrally normalized if asked: the
        W̄ its root handed over for this forward, else its own (through
        ``sn_backend``: K7 as a group of one, or the plain function).  In
        a stage under :func:`remat` the forward keeps its W̄, with the
        graph to ``w`` and ``u`` saved outside the checkpoint, and the
        recompute returns that W̄."""
        if not self.sn:
            return self.w
        store = _REMAT.store
        if store is None:
            return self._sn_weight()
        if _REMAT.replay:
            if self not in store:
                raise RuntimeError(
                    f"{type(self).__name__} {tuple(self.w.shape)} ran in the "
                    f"recompute of a checkpointed stage but not in its "
                    f"forward")
            return store[self]
        if self in store:
            raise RuntimeError(
                f"{type(self).__name__} {tuple(self.w.shape)} was called "
                f"twice in one checkpointed stage")
        with torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            store[self] = self._sn_weight()
        return store[self]

    def _sn_weight(self) -> torch.Tensor:
        w_bar = self._sn_w_bar
        if w_bar is _TAKEN:
            raise RuntimeError(
                f"{type(self).__name__} {tuple(self.w.shape)} was called "
                f"twice in one forward of its SN group: its u would move "
                f"once where the JAX package moves it twice")
        if w_bar is not None:
            self.__dict__["_sn_w_bar"] = _TAKEN
            return w_bar
        with span("sn"):
            w_bar, u_new = spectral_normalize(self.w, self.u, self.sn_iters,
                                              out_dim=self.out_dim,
                                              backend=self.sn_backend,
                                              sharded=self.sharded)
            if self.training:
                with torch.no_grad():
                    self.u.copy_(u_new)
        return w_bar

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """The input, which a sharded layer's backward sums over its model
        peers."""
        return mesh.to_shards(x) if self.sharded else x

    def _bias(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The output (a sharded layer's channels gathered along ``dim``)
        plus the bias, in the layer's dtype."""
        if self.sharded:
            y = mesh.gather_shards(y, dim)
        # fp32 bias on a dtype product promotes to fp32, then back to dtype
        if self.b is not None:
            shape = (-1,) if y.dim() == 2 else (-1, 1, 1)
            y = y + self.b.view(shape)
        return y.to(self.dtype)


def _sn_group_pre_hook(root: nn.Module, args) -> None:
    """Before each forward of ``root``: K7 over all its SN layers in one
    grouped call (storing u for the layers in training mode), each
    layer's W̄ handed over."""
    group = root._sn_group
    with span("sn"):
        w_bars = spectral_norm_group(
            [m.w for m in group], [m.u for m in group],
            [m.sn_iters for m in group], [m.out_dim for m in group],
            dtypes=[m.dtype for m in group],
            store=[m.training for m in group])
    for m, w_bar in zip(group, w_bars):
        m.__dict__["_sn_w_bar"] = w_bar


def _sn_group_post_hook(root: nn.Module, args, output) -> None:
    """After each forward of ``root``: every handed W̄ was taken once (a
    layer called twice raised when it asked again)."""
    skipped = [m for m in root._sn_group if m._sn_w_bar is not _TAKEN]
    for m in root._sn_group:
        m.__dict__["_sn_w_bar"] = None
    if skipped:
        raise RuntimeError(
            f"{len(skipped)} SN layers of {type(root).__name__} took no part "
            f"in its forward, e.g. {type(skipped[0]).__name__} "
            f"{tuple(skipped[0].w.shape)}: the grouped K7 call moved a u "
            f"that the JAX package leaves alone")


def set_sn_backend(root: nn.Module, backend: str) -> None:
    """Route every spectrally normalized layer under ``root`` through
    ``backend``: ``"xla"`` (the plain function) or ``"pallas"`` (K7).  Per
    model, not a process global, as in the JAX package.  ``"pallas"``
    registers on ``root`` the hooks that run K7 once a forward over all
    of them (in ``named_modules`` order); either backend first removes
    such hooks from ``root`` and every module under it (``deepcopy``
    carries them over)."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown SN backend {backend!r}")
    group = [m for m in root.modules() if isinstance(m, _SNLayer) and m.sn]
    for m in group:
        m.sn_backend = backend
    for m in root.modules():
        for hooks, hook in ((m._forward_pre_hooks, _sn_group_pre_hook),
                            (m._forward_hooks, _sn_group_post_hook)):
            for key in [k for k, h in hooks.items() if h is hook]:
                del hooks[key]
        m.__dict__.pop("_sn_group", None)
    if backend == "pallas" and group:
        root.__dict__["_sn_group"] = group
        root.register_forward_pre_hook(_sn_group_pre_hook)
        root.register_forward_hook(_sn_group_post_hook)


class Dense(_SNLayer):
    """y = x @ W (+ b), W [in, out]."""

    def __init__(self, cin, cout, use_bias=True, sn=False, sn_iters=1,
                 dtype=torch.float32, rng=None):
        super().__init__((cin, cout), cout, use_bias, sn, sn_iters, dtype, rng)

    def forward(self, x):
        x = self._in(x.to(self.dtype))
        return self._bias(x @ self.weight().to(self.dtype), -1)


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF/XLA 'SAME': the output is ceil(size / stride); an odd total pad
    puts the extra row on the high side (a 4x4 stride-1 conv pads 1, 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(_SNLayer):
    """NCHW conv with 'SAME' padding, weight OIHW."""

    out_dim = 0

    def __init__(self, cin, cout, kernel=3, stride=1, use_bias=True,
                 sn=False, sn_iters=1, dtype=torch.float32, rng=None):
        super().__init__((cout, cin, kernel, kernel), cout, use_bias, sn,
                         sn_iters, dtype, rng)
        self.kernel, self.stride = kernel, stride

    def forward(self, x):
        top, bottom = _same_padding(x.shape[2], self.kernel, self.stride)
        left, right = _same_padding(x.shape[3], self.kernel, self.stride)
        x = F.pad(self._in(x.to(self.dtype)), (left, right, top, bottom))
        return self._bias(F.conv2d(x, self.weight().to(self.dtype),
                                   stride=self.stride))


def _conv_transpose_padding(kernel: int, stride: int) -> tuple[int, int]:
    """(padding, extra) of ``F.conv_transpose2d`` for TF/XLA 'SAME'
    (``lax.conv_transpose``, output size x stride).  XLA pads the dilated
    input by (k − 1 if s > k − 1 else ceil((k + s − 2) / 2), the rest of
    k + s − 2) on the low and high sides; torch pads both by k − 1 −
    padding, and ``extra`` rows and columns more (fewer when negative) on
    the high side.  4x4/2: (1, 0); 3x3/2: (0, −1), the last row and
    column dropped."""
    total = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return kernel - 1 - low, (total - low) - low


class ConvTranspose(_SNLayer):
    """NCHW transposed conv, 'SAME' (stride s: s× upsampling), weight
    IOHW.  Equals the JAX layer's ``lax.conv_transpose(...,
    transpose_kernel=True)`` of the HWIO kernel ``w.permute(2, 3, 0, 1)``
    with no spatial flip."""

    out_dim = 1

    def __init__(self, cin, cout, kernel=4, stride=2, use_bias=True,
                 sn=False, sn_iters=1, dtype=torch.float32, rng=None):
        super().__init__((cin, cout, kernel, kernel), cout, use_bias, sn,
                         sn_iters, dtype, rng)
        self.stride = stride
        # extra < stride always (s − k when s > k − 1, else 0 or −1)
        self.padding, self.extra = _conv_transpose_padding(kernel, stride)

    def forward(self, x):
        y = F.conv_transpose2d(
            self._in(x.to(self.dtype)), self.weight().to(self.dtype),
            stride=self.stride, padding=self.padding,
            output_padding=max(self.extra, 0))
        if self.extra < 0:
            y = y[:, :, :self.extra, :self.extra]
        return self._bias(y)


class Embedding(_SNLayer):
    """Integer -> vector lookup (the projection discriminator's class
    embedding), weight [num_embeddings, dim] drawn from U(-0.05, 0.05),
    with SN over the embedding axis when ``sn``."""

    def __init__(self, num_embeddings, dim, sn=False, sn_iters=1,
                 dtype=torch.float32, rng=None):
        super().__init__((num_embeddings, dim), dim, False, sn, sn_iters,
                         dtype, rng, w_init=init.uniform)

    def forward(self, ids):
        return self._bias(self.weight()[ids.long()], -1)


class BatchNorm(nn.Module):
    """BatchNorm, eps ``BN_EPS``, fp32 math, result cast to ``dtype``:
    batch moments and a running-stat update in training mode (the moments'
    sums while ``accumulating``), the running stats at eval."""

    accumulating = False   # set between bn_accum_begin and _finalize

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gamma = nn.Parameter(init.ones((c,)))
        self.beta = nn.Parameter(init.zeros((c,)))
        self.register_buffer("mean", init.zeros((c,)))
        self.register_buffer("var", init.ones((c,)))

    def forward(self, x):
        return _bn(self, x, self.gamma.view(-1, 1, 1),
                   self.beta.view(-1, 1, 1))


class ConditionalBatchNorm(nn.Module):
    """Class-conditional BN: per-class gamma/beta tables, shared
    statistics; a ``sharded`` one holds its model rank's columns of the
    tables and gathers the looked-up rows."""

    accumulating = False
    sharded = False

    def __init__(self, c, num_classes, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gamma = nn.Parameter(init.ones((num_classes, c)))
        self.beta = nn.Parameter(init.zeros((num_classes, c)))
        self.register_buffer("mean", init.zeros((c,)))
        self.register_buffer("var", init.ones((c,)))

    def forward(self, x, labels):
        labels = labels.long()
        gamma, beta = self.gamma[labels], self.beta[labels]
        if self.sharded:
            gamma, beta = mesh.gather_shards(torch.stack([gamma, beta]),
                                             2).unbind(0)
        return _bn(self, x, gamma[:, :, None, None], beta[:, :, None, None])


def _bn(layer, x, gamma, beta):
    """``sagan_tpu/nn/layers.py::_bn_core`` on one device.  Training: the
    fp32 batch moments E[x] and E[x²] over (N, H, W), the biased variance
    max(E[x²] − E[x]², 0) for normalizing and for the running stat, and
    running stats updated in place as m·old + (1 − m)·batch with m = 0.99
    (while ``layer.accumulating``: E[x] and E[x²] added to them instead);
    gradients flow through the moments.  (``F.batch_norm``'s running
    update would store the unbiased variance.)  Under a group the moments
    are the mean of the data group's ranks' (cross-replica BN).  The
    recompute of a :func:`remat` stage writes no buffer.  Eval: the running
    stats."""
    x32 = x.float()
    if layer.training:
        mean = x32.mean(dim=(0, 2, 3))
        mean_sq = x32.square().mean(dim=(0, 2, 3))
        if mesh.distributed():
            mean, mean_sq = mesh.all_reduce_mean_grad(
                torch.stack([mean, mean_sq]), mesh.data_group()).unbind(0)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        if not _REMAT.replay:
            with torch.no_grad():
                if layer.accumulating:
                    layer.mean.add_(mean)
                    layer.var.add_(mean_sq)
                else:
                    m = BN_MOMENTUM
                    layer.mean.copy_(m * layer.mean + (1.0 - m) * mean)
                    layer.var.copy_(m * layer.var + (1.0 - m) * var)
    else:
        mean, var = layer.mean, layer.var
    inv = torch.rsqrt(var + BN_EPS)
    y = (x32 - mean.view(-1, 1, 1)) * inv.view(-1, 1, 1) * gamma + beta
    return y.to(layer.dtype)


def bn_moment_paths(root: nn.Module) -> list:
    """Every (conditional) BN under ``root``, in ``modules()`` order: the
    layers whose statistics :func:`bn_accum_begin` and
    :func:`bn_accum_finalize` handle."""
    return [m for m in root.modules()
            if isinstance(m, (BatchNorm, ConditionalBatchNorm))]


@torch.no_grad()
def bn_accum_begin(bns: list) -> list:
    """Put ``bns`` in accumulation mode: their buffers zeroed, to hold the
    sums of the micro-batches' (mean, E[x²]).  Returns the running stats
    they held."""
    saved = []
    for bn in bns:
        saved.append((bn.mean.clone(), bn.var.clone()))
        bn.mean.zero_()
        bn.var.zero_()
        bn.accumulating = True
    return saved


@torch.no_grad()
def bn_accum_finalize(bns: list, saved: list, n: int) -> None:
    """End accumulation mode: the sums averaged over ``n`` micro-batches,
    the variance max(E[x²] − mean², 0), and the momentum applied once
    against the ``saved`` stats, so the running stats are the full
    batch's (mean and E[x²] are linear in the data)."""
    m = BN_MOMENTUM
    for bn, (old_mean, old_var) in zip(bns, saved):
        mean = bn.mean / n
        var = torch.clamp(bn.var / n - mean.square(), min=0.0)
        bn.mean.copy_(m * old_mean + (1.0 - m) * mean)
        bn.var.copy_(m * old_var + (1.0 - m) * var)
        bn.accumulating = False


def leaky_relu(x, alpha=0.1):
    return F.leaky_relu(x, negative_slope=alpha)


def max_pool(x):
    """2x2 stride-2 VALID max pool (the attention K/V downsample)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def global_sum_pool(x):
    """Spatial sum pool [B, C, H, W] -> [B, C] in fp32."""
    return x.float().sum(dim=(2, 3))
