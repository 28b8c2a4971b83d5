"""Material registry and per-instance shading dispatch (port of
:mod:`dust_tpu.render.materials`).

Reference: the ``Material`` trait (``crates/render/src/material.rs``) and
the pipeline manager's per-material-subset pipeline specialization
(``crates/render/src/pipeline/manager.rs:277-315``): one pipeline
permutation per set of materials in the scene and a shader-table record
per (geometry, material).

* **Pipeline permutation:** the per-instance material-type ids
  (``RenderSettings.instance_materials``) are plain Python ints, so a
  frame runs exactly the registered materials' shading code; with only
  palette materials it runs none.
* **Shader-table dispatch:** per-ray dispatch over a handful of material
  types is a short ``where`` chain over the instance id (instances are
  few, rays are the wide axis).

``PaletteMaterial`` (type id 0, the default) is the baseline shading that
:func:`dust_tpu_torch.ops.shade.resolve_hits` computes; other materials
refine its result for their lanes. :class:`EmissiveMaterial` adds a
deterministic emission term that the pipeline composes into the direct
channel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Material", "PaletteMaterial", "EmissiveMaterial",
           "register_material", "material_registry", "apply_materials"]


@dataclass(frozen=True)
class Material:
    """Base material: contributes nothing beyond the palette baseline."""

    name: str = "base"

    def shade(self, g: dict, lanes: torch.Tensor) -> dict:
        """Refine shading for rays in ``lanes`` (bool (N,)).

        ``g`` is resolve_hits' G-buffer dict. Returns a dict of updates:
        ``albedo`` (N, 4) replaces the baseline for those lanes;
        ``emissive`` (N, 3) adds deterministic radiance (composed into the
        direct channel). Missing keys = no change."""
        return {}


@dataclass(frozen=True)
class PaletteMaterial(Material):
    """Type id 0: the vox palette material. Baseline: resolve_hits already
    computed it."""

    name: str = "palette"


@dataclass(frozen=True)
class EmissiveMaterial(Material):
    """Palette colour re-emitted as light: albedo × strength joins the
    direct (zero-variance) channel."""

    name: str = "emissive"
    strength: float = 4.0

    def shade(self, g: dict, lanes: torch.Tensor) -> dict:
        em = g["albedo"][:, :3] * self.strength
        return {"emissive": torch.where(lanes[:, None], em, 0.0)}


_REGISTRY: dict[int, Material] = {0: PaletteMaterial()}


def material_registry() -> dict[int, Material]:
    return dict(_REGISTRY)


def register_material(type_id: int, material: Material) -> None:
    """Register a material type (id > 0; 0 is the palette baseline)."""
    if type_id == 0:
        raise ValueError("type 0 is the palette baseline")
    _REGISTRY[int(type_id)] = material


def apply_materials(g: dict, ids: tuple,
                    registry: dict[int, Material] | None = None):
    """Dispatch non-palette materials over their instances' rays.

    ``ids`` is the per-instance material-type tuple
    (``RenderSettings.instance_materials``). Returns ``(g, emissive)``;
    with no non-palette instance ``g`` comes back as it was and the
    emission is zero.

    The registry is read at every call: the port compiles nothing per
    frame, so a type registered again with other parameters takes effect
    at the next frame."""
    hit = g["hit"]
    n = hit.shape[0]
    emissive = torch.zeros((n, 3), device=hit.device)
    if not ids or all(t == 0 for t in ids):
        return g, emissive
    if registry is None:
        registry = _REGISTRY

    inst = g.get("inst")
    for type_id in sorted(set(ids) - {0}):
        mat = registry.get(type_id)
        if mat is None:
            raise KeyError(f"material type {type_id} not registered")
        lanes = torch.zeros(n, dtype=torch.bool, device=hit.device)
        for i, t in enumerate(ids):
            if t == type_id:
                lanes = lanes | (inst == i)
        lanes = lanes & hit
        out = mat.shade(g, lanes)
        if "albedo" in out:
            g = dict(g)
            g["albedo"] = torch.where(lanes[:, None], out["albedo"],
                                      g["albedo"])
        if "emissive" in out:
            emissive = emissive + out["emissive"]
    return g, emissive
