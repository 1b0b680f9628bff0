"""Staged checkpoint and resume for the halo-model pipeline (port of
hmvec_tpu/utils/checkpoint.py).

Any dict of arrays or tensors round-trips through one .npz file, so an
expensive stage state can be computed once and reloaded.  The key layout
is the JAX package's (the grids, ``Pzk``, ``sigma2``, ``nzm``, ``bh``, then
``uk__NAME``, ``uk2__NAME``, ``pk__NAME``, ``cib__NAME__FIELD`` and
``hod__NAME__FIELD``), so a checkpoint that either package writes
restores into the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.weights import host

_HOD_FIELDS = ("Nc", "Ns", "NsNsm1", "NcNs", "ngal", "bg")
_CIB_FIELDS = ("fc", "fs", "us", "us2")


def save_stages(path: str, **arrays):
    """Save named arrays or tensors (read back to the host) to ``path``
    (.npz, compressed)."""
    np.savez_compressed(path, **{k: host(v) if isinstance(v, torch.Tensor)
                                 else np.asarray(v)
                                 for k, v in arrays.items()})


def load_stages(path: str, device=None):
    """A stage checkpoint as a dict of tensors on ``device`` (None: numpy
    arrays, as the file holds them)."""
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    if device is not None:
        out = {k: torch.as_tensor(v, device=device) for k, v in out.items()}
    return out


def save_halo_model(hm, path: str):
    """Persist a HaloModel's computed stage state (mass function, linear
    power, profiles, CIB/HI tracers and HODs)."""
    arrays = {
        "zs": hm.zs, "ks": hm.ks, "ms": hm.ms,
        "Pzk": hm.Pzk, "sigma2": hm.sigma2, "nzm": hm.nzm, "bh": hm.bh,
    }
    for name, uk in hm.uk_profiles.items():
        arrays[f"uk__{name}"] = uk
    for name, uk2 in hm.uk2_profiles.items():
        arrays[f"uk2__{name}"] = uk2       # <u^2> of conc-scatter profiles
    for name, pk in hm.pk_profiles.items():
        arrays[f"pk__{name}"] = pk
    for name, cib in hm.cib_tracers.items():
        for field in _CIB_FIELDS:
            val = getattr(cib, field)
            if val is not None:
                arrays[f"cib__{name}__{field}"] = val
    for name, hod in hm.hods.items():
        for key in _HOD_FIELDS:
            arrays[f"hod__{name}__{key}"] = hod[key]
    save_stages(path, **arrays)


def restore_halo_model(hm, path: str):
    """Restore the stage state that save_halo_model wrote into ``hm`` in
    place, as float64 tensors on its device.  The grids must match;
    raises if they do not.  Every table the file holds replaces the
    instance's own (profiles, tracers and HODs of other names stay); the
    instance keeps no derived copy of them, so nothing computed from the
    state before the restore survives it."""
    data = load_stages(path)
    for grid in ("zs", "ks", "ms"):
        mine = getattr(hm, grid + "_np")
        if data[grid].shape != mine.shape or not np.allclose(data[grid],
                                                             mine):
            raise ValueError(f"checkpoint grid {grid!r} does not match model")

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=hm.device)

    hm.Pzk = t(data["Pzk"])
    hm.sigma2 = t(data["sigma2"])
    hm.nzm = t(data["nzm"])
    hm.bh = t(data["bh"])
    cib_fields: dict = {}
    for key, val in data.items():
        if key.startswith("uk2__"):
            hm.uk2_profiles[key[5:]] = t(val)
        elif key.startswith("uk__"):
            hm.uk_profiles[key[4:]] = t(val)
            if f"uk2__{key[4:]}" not in data:
                hm.uk2_profiles.pop(key[4:], None)
        elif key.startswith("pk__"):
            hm.pk_profiles[key[4:]] = t(val)
        elif key.startswith("cib__"):
            _, name, field = key.split("__")
            cib_fields.setdefault(name, {})[field] = t(val)
        elif key.startswith("hod__"):
            _, name, field = key.split("__")
            hod = hm.hods.setdefault(name, {"satellite_profile": "nfw",
                                            "central_profile": None})
            hod[field] = t(val)
    if cib_fields:
        from ..models.power import CIBTracer
        for name, fields in cib_fields.items():
            hm.cib_tracers[name] = CIBTracer(**fields)
    return hm
