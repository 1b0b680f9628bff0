"""Neural emulators of halo-model observables, trained on the device (port
of hmvec_tpu/models/emulator.py).

The training set is generated by the port's own batched surface: the
target function under ``torch.func.vmap``, one call a chunk of
cosmologies, so each hand-written kernel of a ``make_*_fn`` product
launches once per chunk (as in ``pipeline.make_batched_fn``).  The
emulator is a small MLP (an ``nn.Module``; GELU in its tanh form, as
``jax.nn.gelu`` defaults to) trained with full-batch AdamW in a Python
loop on the device of the target: the JAX package's optax chain,
``adamw(cosine_decay_schedule(lr, steps), weight_decay)``, written out --
m = (1-b1) g + b1 m, v = (1-b2) g^2 + b2 v, u = m_hat / (sqrt(v_hat) +
eps) + wd p, p += -lr(t) u with lr(t) = lr (1 + cos(pi t / steps)) / 2,
the decay on the biases too.  The fitted ``Emulator`` differentiates like
any other module (``torch.func.jacfwd(em)(theta)``).

Weights carry across packages: ``Emulator`` builds from a dict
{"W": [...], "b": [...]} of arrays laid out like the JAX package's net,
``load_emulator`` reads the .npz that either package's ``save_emulator``
writes, and ``fit_emulator(init_net=...)`` starts from a given net (the
JAX package's ``_init_net`` output, for one).  Sampling is the same
scrambled Sobol' draw (scipy.stats.qmc) as the JAX package's.  With
``mesh=`` (a ``parallel.sharding.Mesh``) the fit is data-parallel: the
training rows are sharded over the mesh's slots, each slot forms its share
of the squared error with the net copied to its device, and the shares'
psum on the mesh's first device gives the loss whose gradient each AdamW
step takes there.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.weights import device_of

__all__ = ["Emulator", "fit_emulator", "sample_params", "pipeline_target",
           "save_emulator", "load_emulator"]

_F64 = torch.float64
# optax.adamw's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def sample_params(lo, hi, n, seed=0):
    """Scrambled-Sobol' sample of the box [lo, hi]^d -> (n, d) float64
    numpy array (the JAX package's draw, bit for bit)."""
    lo = np.atleast_1d(np.asarray(lo, dtype=np.float64))
    hi = np.atleast_1d(np.asarray(hi, dtype=np.float64))
    if lo.shape != hi.shape:
        raise ValueError("lo/hi shape mismatch")
    from scipy.stats import qmc
    with warnings.catch_warnings():
        # scipy warns when n is not a power of two; balance is irrelevant
        # for a regression training set
        warnings.simplefilter("ignore")
        u = qmc.Sobol(lo.size, scramble=True, seed=seed).random(int(n))
    return lo + (hi - lo) * u


def _tensor(a, device):
    """a tensor moved to ``device``, or an array copied there (a copy: the
    arrays handed over may be read-only views)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.array(a), device=device)


def _init_net(generator, sizes, dtype, device):
    """He-normal weights (drawn in float64, scaled by sqrt(2 / fan_in),
    then cast, as the JAX package's) and zero biases."""
    Ws, bs = [], []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=_F64,
                        device=device) * np.sqrt(2.0 / din)
        Ws.append(w.to(dtype))
        bs.append(torch.zeros((dout,), dtype=dtype, device=device))
    return {"W": Ws, "b": bs}


class _MLP(nn.Module):
    """x @ W + b with tanh-form GELU between layers; ``net["W"]`` and
    ``net["b"]`` list the layers' tensors as the JAX package's dict
    does."""

    def __init__(self, Ws, bs):
        super().__init__()
        self.W = nn.ParameterList(Ws)
        self.b = nn.ParameterList(bs)

    def __getitem__(self, key):
        return list(getattr(self, key))

    def forward(self, x):
        return _net_apply(self, x)


def _net_apply(net, x):
    """The MLP of a net ({"W": [...], "b": [...]} or an ``_MLP``) at x."""
    Ws, bs = net["W"], net["b"]
    h = x
    for W, b in zip(Ws[:-1], bs[:-1]):
        h = F.gelu(h @ W + b, approximate="tanh")
    return h @ Ws[-1] + bs[-1]


class Emulator(nn.Module):
    """Fitted MLP emulator theta -> observable vector.

    ``net``: an ``_MLP`` or a dict {"W": [...], "b": [...]} of arrays or
    tensors (the JAX package's layout, (d_in, d_out) weights); the
    standardization vectors likewise.  Call with theta of shape (d,) or
    (B, d); returns (out,) or (B, out) in float64 (the MLP evaluates in
    its weights' dtype).  ``device``: None -- the net's tensors' device,
    or the card for host arrays."""

    def __init__(self, net, x_mu, x_sd, y_mu, y_sd, log_y=False,
                 device=None):
        super().__init__()
        dev = torch.device(device) if device is not None else (
            device_of(net if isinstance(net, dict) else
                      list(net.parameters())) or torch.device("cuda"))
        if not isinstance(net, nn.Module):
            net = _MLP([nn.Parameter(_tensor(w, dev)) for w in net["W"]],
                       [nn.Parameter(_tensor(b, dev)) for b in net["b"]])
        self.net = net.to(dev)
        for name, v in (("x_mu", x_mu), ("x_sd", x_sd), ("y_mu", y_mu),
                        ("y_sd", y_sd)):
            self.register_buffer(name, _tensor(v, dev).to(_F64))
        self.log_y = bool(log_y)

    @property
    def device(self):
        return self.x_mu.device

    def forward(self, theta):
        theta = torch.as_tensor(theta, dtype=_F64, device=self.device)
        single = theta.dim() == 1
        x = torch.atleast_2d(theta)
        dtype = self.net.W[0].dtype
        xs = ((x - self.x_mu) / self.x_sd).to(dtype)
        y = self.net(xs).to(_F64)
        y = y * self.y_sd + self.y_mu
        if self.log_y:
            y = torch.exp(y)
        return y[0] if single else y


def _tree_leaves(tree):
    """The leaves of a result in ``jax.tree_util.tree_leaves``' order:
    dicts by sorted key, lists, tuples and named tuples in order, None
    skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _tree_leaves(v)]
    return [tree]


def pipeline_target(fn, param_names, base=None, postprocess=None):
    """Adapt a pipeline builder product into ``theta_row -> flat vector``.

    fn: a ``make_*_fn`` product (overrides dict -> tensor or tuple), the
    same contract ``pipeline.make_batched_fn`` consumes; the target keeps
    its ``device``.  postprocess: optional result -> result applied before
    flattening (e.g. select one spectrum of a tuple).  The leaves are
    flattened in the JAX package's order (dict keys sorted)."""
    names = tuple(param_names)
    base = dict(base or {})

    def target(theta_row):
        ov = dict(base)
        for i, name in enumerate(names):
            ov[name] = theta_row[i]
        out = fn(ov)
        if postprocess is not None:
            out = postprocess(out)
        return torch.cat([torch.ravel(l) for l in _tree_leaves(out)])

    target.device = getattr(fn, "device", None)
    return target


def _training_set(fn, thetas, chunk, device):
    """fn at each row of thetas, ``chunk`` rows a ``torch.func.vmap`` call
    on ``device``, as a float64 numpy array (rows, out)."""
    gen = torch.func.vmap(fn)
    ys = []
    for s in range(0, thetas.shape[0], int(chunk)):
        th = torch.as_tensor(thetas[s:s + chunk], dtype=_F64, device=device)
        with torch.no_grad():
            ys.append(gen(th).detach().cpu().numpy())
    return np.concatenate(ys, axis=0)


def _cosine_lr(learning_rate, steps, t):
    """optax.cosine_decay_schedule(learning_rate, steps)(t), closed form."""
    return learning_rate * (0.5 * (1 + math.cos(math.pi * min(t, steps)
                                                / steps)))


def _adamw(params, grads, m, v, t, lr, weight_decay):
    """One optax.adamw step (step count t >= 1) in place, in the
    parameters' dtype with optax's order of operations."""
    bc1, bc2 = 1 - _B1**t, 1 - _B2**t
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.copy_((1 - _B1) * g + _B1 * mi)
        vi.copy_((1 - _B2) * g**2 + _B2 * vi)
        u = (mi / bc1) / (torch.sqrt(vi / bc2 + 0.0) + _EPS)
        u = u + weight_decay * p
        p.add_(-lr * u)


def fit_emulator(fn, lo, hi, n_train=1024, n_val=128, widths=(128, 128, 128),
                 steps=2000, learning_rate=3e-3, weight_decay=1e-4,
                 log_y=False, chunk=64, seed=0, key=0, mesh=None,
                 dtype=torch.float32, verbose=False, init_net=None,
                 device=None):
    """Generate a training set from ``fn`` and fit an MLP emulator to it.

    fn: theta_row (d,) -> flat observable vector (out,), a function of
        tensors that ``torch.func.vmap`` takes (wrap pipeline builders with
        :func:`pipeline_target`).  Everything runs on ``device``, by
        default fn's own ``device`` (a pipeline product's), else the card.
    lo, hi: parameter-box bounds, shape (d,).
    log_y: fit log(y) (outputs must be positive).
    chunk: cosmologies per vmapped generation call (memory bound).
    key: int seed (or ``torch.Generator``) of the MLP's initial weights.
    init_net: optional initial net, a dict {"W": [...], "b": [...]} in the
        JAX package's layout (its ``_init_net`` output carries a JAX-made
        start across); cast to ``dtype``; overrides ``key``.
    mesh: optional ``parallel.sharding.Mesh``: the training rows are
        sharded over its slots and the fit runs on its first device (the
        training set is still generated on fn's device).  n_train is
        truncated to a multiple of the mesh size.

    Returns (Emulator, info) with info["losses"] the per-step training MSE
    (standardized units, numpy, in ``dtype``) and, when n_val > 0,
    info["val_max_rel"] / info["val_rms_rel"], held-out relative errors in
    the original (de-logged) output space.
    """
    if mesh is not None:
        n_train = (n_train // mesh.size) * mesh.size
        if n_train == 0:
            raise ValueError("n_train smaller than the mesh")
    dev = torch.device(device if device is not None else
                       getattr(fn, "device", None) or "cuda")
    thetas = sample_params(lo, hi, n_train + n_val, seed=seed)
    Y = _training_set(fn, thetas, chunk, dev)
    if not np.all(np.isfinite(Y)):
        raise FloatingPointError("non-finite training outputs from fn")
    if log_y:
        if np.any(Y <= 0):
            raise ValueError("log_y=True requires positive outputs")
        Yf = np.log(Y)
    else:
        Yf = Y

    x_mu = thetas[:n_train].mean(axis=0)
    x_sd = thetas[:n_train].std(axis=0)
    x_sd = np.where(x_sd > 0, x_sd, 1.0)
    y_mu = Yf[:n_train].mean(axis=0)
    y_sd = Yf[:n_train].std(axis=0)
    y_sd = np.where(y_sd > 0, y_sd, 1.0)

    X = torch.as_tensor((thetas[:n_train] - x_mu) / x_sd).to(dtype)
    Yt = torch.as_tensor((Yf[:n_train] - y_mu) / y_sd).to(dtype)
    if mesh is None:
        X, Yt = X.to(dev), Yt.to(dev)
    else:
        dev = mesh.devices[0]
        shards = list(zip(mesh.shard(X), mesh.shard(Yt)))

    def loss_fn():
        if mesh is None:
            return torch.mean((mlp(X) - Yt) ** 2)
        parts = []
        for slot, (x, y) in zip(mesh.devices, shards):
            net = {k: [w.to(slot) for w in mlp[k]] for k in ("W", "b")}
            parts.append(torch.sum((_net_apply(net, x) - y) ** 2))
        return mesh.psum(parts) / Yt.numel()

    sizes = (thetas.shape[1],) + tuple(int(w) for w in widths) \
        + (Yf.shape[1],)
    if init_net is not None:
        net = {k: [_tensor(a, dev).to(dtype) for a in init_net[k]]
               for k in ("W", "b")}
        got = tuple(w.shape[0] for w in net["W"]) + (net["W"][-1].shape[1],)
        if got != sizes:
            raise ValueError(f"init_net has layer sizes {got}, the fit "
                             f"needs {sizes}")
    else:
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=dev).manual_seed(int(key))
        net = _init_net(key, sizes, dtype, dev)
    mlp = _MLP([nn.Parameter(w.clone()) for w in net["W"]],
               [nn.Parameter(b.clone()) for b in net["b"]])
    params = list(mlp.parameters())
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]

    losses = []
    for t in range(int(steps)):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            _adamw(params, grads, m, v, t + 1,
                   _cosine_lr(learning_rate, int(steps), t), weight_decay)
        losses.append(loss.detach())
    em = Emulator(mlp, x_mu, x_sd, y_mu, y_sd, log_y=log_y, device=dev)

    info = {"losses": torch.stack(losses).cpu().numpy() if losses
            else np.zeros(0), "sizes": sizes}
    if n_val > 0:
        with torch.no_grad():
            pred = em(thetas[n_train:]).cpu().numpy()
        truth = Y[n_train:]
        rel = np.abs(pred - truth) / np.maximum(np.abs(truth), 1e-300)
        info["val_max_rel"] = float(rel.max())
        info["val_rms_rel"] = float(np.sqrt((rel ** 2).mean()))
    if verbose:
        tail = float(np.mean(info["losses"][-50:]))
        msg = f"emulator fit: final MSE {tail:.3e}"
        if n_val > 0:
            msg += (f", val max rel {info['val_max_rel']:.3e}"
                    f", rms {info['val_rms_rel']:.3e}")
        print(msg)
    return em, info


def save_emulator(em, path):
    """Serialize an Emulator to one .npz on the host, in the JAX package's
    layout (either package's load_emulator reads it)."""
    blob = {"log_y": np.asarray(int(em.log_y)),
            "n_layers": np.asarray(len(em.net.W))}
    for name in ("x_mu", "x_sd", "y_mu", "y_sd"):
        blob[name] = getattr(em, name).detach().cpu().numpy()
    for i, (w, b) in enumerate(zip(em.net.W, em.net.b)):
        blob[f"W{i}"] = w.detach().cpu().numpy()
        blob[f"b{i}"] = b.detach().cpu().numpy()
    np.savez(path, **blob)


def load_emulator(path, device="cuda"):
    """An Emulator from a save_emulator .npz of either package, on
    ``device``."""
    with np.load(path) as f:
        n = int(f["n_layers"])
        net = {"W": [f[f"W{i}"] for i in range(n)],
               "b": [f[f"b{i}"] for i in range(n)]}
        return Emulator(net, f["x_mu"], f["x_sd"], f["y_mu"], f["y_sd"],
                        log_y=bool(int(f["log_y"])), device=device)
