"""Convert the reference demo geometry (cornell.obj, suzanne.obj —
project/demo/geometry/, wired into the demo at demo.tscn:69-93) into the
packed npz asset shipped with the package
(gdpathtracing/scene/data/demo_geometry.npz).

The npz stores, per mesh, the per-surface triangle arrays produced by
scene.objloader.load_obj (positions/normals/uvs per surface) — pure
geometry data, no code. Suzanne is the standard Blender monkey primitive;
cornell is a 5-face box with 3 material groups.

Run once (the asset is committed):
    PYTHONPATH=/root/repo python examples/convert_demo_assets.py \
        /root/reference/project/demo/geometry
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gdpathtracing.scene.objloader import load_obj  # noqa: E402

OUT = (Path(__file__).resolve().parents[1] / "gdpathtracing" / "scene"
       / "data" / "demo_geometry.npz")


def main(src_dir: str) -> None:
    src = Path(src_dir)
    arrays = {}
    for name in ("cornell", "suzanne"):
        surfaces = load_obj(str(src / f"{name}.obj"))
        arrays[f"{name}_n_surfaces"] = np.int32(len(surfaces))
        for k, s in enumerate(surfaces):
            arrays[f"{name}_{k}_positions"] = s.positions
            if s.normals is not None:
                arrays[f"{name}_{k}_normals"] = s.normals
            if s.uvs is not None:
                arrays[f"{name}_{k}_uvs"] = s.uvs
        tris = sum(s.positions.shape[0] for s in surfaces)
        print(f"{name}: {len(surfaces)} surfaces, {tris} triangles")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else "/root/reference/project/demo/geometry")
