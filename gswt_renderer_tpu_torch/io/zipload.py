"""Tile-set loading from zip archives / directories (scene.rs:1030-1141).

Entries named ``lod{L}_tile_{T}.(ply|splat)`` are collected and returned as a
[n_lod][n_tile] nested list of Scenes, sorted by (lod, tile) exactly like the
reference (scene.rs:1057-1096).
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import List

from .ply import Scene

_NAME_RE = re.compile(r"lod(\d+)_tile_(\d+)")


def _assemble(entries) -> List[List[Scene]]:
    """entries: list of (lod_id, tile_id, filename, bytes)."""
    if not entries:
        return []
    entries.sort(key=lambda e: (e[0], e[1]))
    first_lod = entries[0][0]
    last_lod = entries[-1][0]
    n_lod = last_lod - first_lod + 1
    n_tile = entries[-1][1] + 1
    if len(entries) != n_lod * n_tile:
        raise ValueError(
            f"tile set incomplete: expected {n_lod}x{n_tile} entries, got {len(entries)}"
        )
    scene_vec: List[List[Scene]] = []
    for i in range(n_lod):
        lod_vec = []
        for j in range(n_tile):
            lod_id, tile_id, filename, data = entries[i * n_tile + j]
            if ".ply" in filename:
                scene = Scene.from_ply_bytes(data)
            elif ".splat" in filename:
                scene = Scene.from_splat_bytes(data)
            else:
                raise ValueError(f"unsupported tile file: {filename}")
            lod_vec.append(scene)
        scene_vec.append(lod_vec)
    return scene_vec


def load_scene_zip(path) -> List[List[Scene]]:
    entries = []
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            name = os.path.basename(info.filename)
            m = _NAME_RE.search(name)
            if m is None:
                continue
            entries.append((int(m.group(1)), int(m.group(2)), name, zf.read(info)))
    return _assemble(entries)


def load_scene_dir(path) -> List[List[Scene]]:
    entries = []
    for name in os.listdir(path):
        m = _NAME_RE.search(name)
        if m is None:
            continue
        with open(os.path.join(path, name), "rb") as fh:
            entries.append((int(m.group(1)), int(m.group(2)), name, fh.read()))
    return _assemble(entries)
