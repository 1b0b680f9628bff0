"""The system under test: a configuration's entry point of
``hmvec_tpu_torch``, batched over the traffic's parameters.

A configuration names its entry (``"pipeline.make_pmm_fn"``: a factory
under ``hmvec_tpu_torch`` that takes the grids and the options), its grids
and its options.  On one device the batch runs through
``pipeline.make_batched_fn``; on several, through
``parallel.sharding.make_sharded_batched_fn`` over a mesh of those devices
(data-parallel serving: each card computes its share of the rows, and the
gather brings them to the first card).  The configuration's ``out_dtype``
goes to whichever of the two takes one.
"""

from __future__ import annotations

import importlib
import inspect

import torch

from ..reference.halo_pmm import grids

_DTYPES = {"float32": torch.float32, "float64": torch.float64, None: None}


def build(cfg: dict, param_names, devices):
    """batched(theta (B, P) numpy) -> a tensor (B, ...) on devices[0], or
    a tuple of them for an entry that returns several spectra."""
    mod_name, fn_name = cfg["entry"].rsplit(".", 1)
    factory = getattr(importlib.import_module(f"hmvec_tpu_torch.{mod_name}"),
                      fn_name)
    pl = importlib.import_module("hmvec_tpu_torch.pipeline")
    opts = dict(cfg["options"])
    if opts.get("uk_subsample") is not None:
        opts["uk_subsample"] = tuple(opts["uk_subsample"])
    zs, ms, ks = grids(cfg)
    fn = factory(zs, ks, ms, device=devices[0], **opts)
    if len(devices) == 1:
        serve, extra = pl.make_batched_fn, ()
    else:
        sh = importlib.import_module("hmvec_tpu_torch.parallel.sharding")
        serve = sh.make_sharded_batched_fn
        extra = (sh.make_mesh(devices=list(devices)),)
    return serve(fn, param_names, *extra, **out_dtype(serve, cfg))


def out_dtype(serve, cfg: dict) -> dict:
    """The configuration's output type, for an entry that takes one.  An
    entry without ``out_dtype`` (``make_sharded_batched_fn`` today) returns
    its rows as the configuration's entry computes them, in float64."""
    if "out_dtype" not in inspect.signature(serve).parameters:
        return {}
    return {"out_dtype": _DTYPES[cfg.get("out_dtype")]}
