"""State carried across from the JAX package, as NumPy.

The FEM has no weights: its state is the mesh, the DOF maps and the BSR
tables. These helpers build the port's objects from a JAX package object's
arrays handed over as NumPy, so both packages can run on byte-identical
inputs. They take NumPy only and never import the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .mesh.fracture_network import FractureNetworkMesh
from .mesh.mesh_tri import _freeze
from .ops.bsr import BSRStructure

_DEVICE_FIELDS = ("bcols", "entry_slot", "bcols2", "heavy_rows", "entry_slot_sym", "tpartner")
_HOST_FIELDS = ("perm", "inner_perm", "ubr_host", "ubc_host", "blk_id_host")


def mesh_from_numpy(arrays: dict, *, device=None, dtype=None) -> FractureNetworkMesh:
    """A ``FractureNetworkMesh`` from the nested dict of NumPy arrays a JAX
    mesh holds (``{"cells": {"vertices": ..., ...}, ...}``).

    Float arrays take ``dtype`` (default ``config.default_dtype()``),
    integer arrays the index dtype.
    """
    groups = _freeze(
        arrays, config.resolve_device(device), dtype or config.default_dtype()
    )
    return FractureNetworkMesh(_groups=groups)


def structure_from_numpy(fields: dict, *, device=None) -> BSRStructure:
    """A ``BSRStructure`` from a dict of its fields as NumPy arrays and
    Python ints (e.g. ``{k: np.asarray(v) for k, v in st._asdict().items()}``
    of a JAX structure). Device tables become int32 tensors on ``device``;
    host tables stay NumPy."""
    device = config.resolve_device(device)
    kwargs = {}
    for name in BSRStructure._fields:
        value = fields.get(name)
        if value is None:
            kwargs[name] = None
        elif name in _DEVICE_FIELDS:
            kwargs[name] = torch.as_tensor(
                np.asarray(value).astype(np.int32),
                dtype=config.index_dtype(),
                device=device,
            )
        elif name in _HOST_FIELDS:
            kwargs[name] = np.asarray(value)
        else:
            kwargs[name] = int(value)
    return BSRStructure(**kwargs)
