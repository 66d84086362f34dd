"""Weights in the JAX package's layout that are a fixed function of a seed.

The reference's ``init_params`` seeds each leaf with ``abs(hash(path))``,
and Python salts string hashes per process (``PYTHONHASHSEED``), so it
draws new weights in every process. The port's tests that hold the port
to the reference draw their weights here instead, with the reference's
own leaf rules (``repro.models.params._init_leaf``): ``zeros``, ``ones``,
otherwise a standard normal times ``spec.scale`` or 1/sqrt(fan_in). The
normals come from ``np.random.default_rng(seed)``, leaf after leaf in the
order of jax's tree flattening (dict keys sorted), as float32 numpy
arrays, the dtype the reference's ``init_params`` gives by default.
"""
import jax
import numpy as np

from repro.models.params import _fan_in, is_spec


def ref_params(spec_tree, seed):
    """A numpy params tree for ``spec_tree`` (the reference's
    ``model_specs``), the same in every process for one ``seed``."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(spec_tree, is_leaf=is_spec)
    out = []
    for spec in leaves:
        if spec.init == "zeros":
            out.append(np.zeros(spec.shape, np.float32))
        elif spec.init == "ones":
            out.append(np.ones(spec.shape, np.float32))
        else:
            std = (spec.scale if spec.scale is not None
                   else 1.0 / np.sqrt(_fan_in(spec.shape)))
            out.append((rng.standard_normal(spec.shape, np.float32)
                        * np.float32(std)).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)
