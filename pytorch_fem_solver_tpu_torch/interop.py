"""State carried across from the JAX package, as NumPy.

The FEM's state is the mesh, the DOF maps and the BSR tables; a VPINN adds
the network's weights. These helpers build the port's objects from a JAX
package object's arrays handed over as NumPy, so both packages can run on
byte-identical inputs. They take NumPy only and never import the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .mesh.fracture_network import FractureNetworkMesh
from .mesh.mesh_tri import _freeze
from .models.network import FeedForwardNeuralNetwork
from .ops.bsr import BSRStructure, index_tables, row_tables
from .ops.precondition import AggBlockTwoLevel

_DEVICE_FIELDS = (
    "bcols", "entry_slot", "bcols2", "heavy_rows", "entry_slot_sym", "tpartner",
    "row_blocks", "heavy_rank",
)
_HOST_FIELDS = ("perm", "inner_perm", "ubr_host", "ubc_host", "blk_id_host")
_INDEX_FIELDS = ("inner_perm_index", "tpartner_index", "tperm")


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
    of a JAX structure). Device tables become int32 tensors on ``device``,
    gather tables int64 ones; host tables stay NumPy. The tables a JAX
    structure does not carry are derived: the SpMV kernel's ``row_blocks``
    and ``heavy_rank`` from its ``ubr_host`` and ``heavy_rows``, the gather
    tables from ``inner_perm``, ``tpartner`` and ``block``."""
    device = config.resolve_device(device)
    if fields.get("row_blocks") is None and fields.get("ubr_host") is not None:
        row_blocks, heavy_rank = row_tables(
            fields["ubr_host"], int(fields["nb"]), fields["heavy_rows"]
        )
        fields = dict(fields, row_blocks=row_blocks, heavy_rank=heavy_rank)
    if fields.get("tperm") is None and fields.get("tpartner") is not None:
        fields = dict(
            fields,
            **index_tables(fields["inner_perm"], fields["tpartner"], int(fields["block"])),
        )
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
        elif name in _INDEX_FIELDS:
            kwargs[name] = torch.as_tensor(
                np.asarray(value), dtype=torch.int64, device=device
            )
        elif name in _HOST_FIELDS:
            kwargs[name] = np.asarray(value)
        else:
            kwargs[name] = int(value)
    return BSRStructure(**kwargs)


def agg_block_two_level_from_numpy(
    inv_agg, coarse_inv, g: int, gs: int, *, device=None, dtype=None
) -> AggBlockTwoLevel:
    """An ``AggBlockTwoLevel`` from the NumPy arrays of a JAX one
    (``inv_agg`` (ns, gs, gs), ``coarse_inv`` (nc, nc)) and its sizes.
    Arrays take ``dtype`` (default ``config.default_dtype()``)."""
    device = config.resolve_device(device)
    dtype = dtype or config.default_dtype()

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return AggBlockTwoLevel(
        inv_agg=dev(inv_agg), coarse_inv=dev(coarse_inv), g=int(g), gs=int(gs)
    )


def network_from_numpy(weights, biases, **arch) -> FeedForwardNeuralNetwork:
    """The port's network holding a JAX network's ``weights`` / ``biases``
    tuples (as NumPy, each weight (fan_in, fan_out)). ``arch`` takes the
    constructor's arguments (``input_dimension``, ..., ``device``,
    ``dtype``); the seeded draw is overwritten."""
    net = FeedForwardNeuralNetwork(**arch)
    if len(weights) != net.n_layers or len(biases) != net.n_layers:
        raise ValueError(
            f"expected {net.n_layers} weights and biases, got "
            f"{len(weights)} and {len(biases)}"
        )
    params = {f"w{i}": w for i, w in enumerate(weights)}
    params.update({f"b{i}": b for i, b in enumerate(biases)})
    return net.with_parameters(params)
