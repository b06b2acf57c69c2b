"""Minimal PLY mesh IO (binary little-endian), replacing trimesh export
(this package's own copy of nicer_slam_tpu/utils/ply.py, numpy only).

Writes/reads vertices (+optional per-vertex normals and uchar colors) and
triangle faces — the subset the reference produces via trimesh
(utils/plots.py:152-155) and the eval tools consume.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              normals: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    V = verts.shape[0]
    F = faces.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {V}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {F}",
               "property list uchar int vertex_indices", "end_header"]

    cols = [verts]
    if normals is not None:
        cols.append(np.asarray(normals, np.float32))
    vdata = np.concatenate(cols, axis=1).astype("<f4")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(vdata.tobytes())
        else:
            c = np.asarray(colors)
            if c.dtype != np.uint8:
                c = np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8)
            rec = np.empty(V, dtype=[("v", "<f4", (vdata.shape[1],)),
                                     ("c", "u1", (3,))])
            rec["v"] = vdata
            rec["c"] = c[:, :3]
            f.write(rec.tobytes())
        frec = np.empty(F, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Reads binary-LE or ascii PLY with float vertex props + int face
    lists. Returns dict with 'verts', 'faces', optional 'normals',
    'colors'."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    body = data[head_end:]

    fmt = "binary_little_endian"
    elements = []  # (name, count, [(prop_type, prop_name) or ('list',...)])
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur[2].append((parts[1], parts[2]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                "uint": "<u4", "short": "<i2", "ushort": "<u2", "char": "i1"}

    out: Dict[str, np.ndarray] = {}
    if fmt.startswith("ascii"):
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(text[pos:pos + count * width],
                                 np.float64).reshape(count, width)
                pos += count * width
                names = [p[1] for p in props]
                out["verts"] = arr[:, [names.index(c) for c in "xyz"]].astype(np.float32)
                if "nx" in names:
                    out["normals"] = arr[:, [names.index(c) for c in
                                             ("nx", "ny", "nz")]].astype(np.float32)
                if "red" in names:
                    out["colors"] = arr[:, [names.index(c) for c in
                                            ("red", "green", "blue")]].astype(np.uint8)
            elif name == "face":
                faces = []
                for _ in range(count):
                    n = int(text[pos]); pos += 1
                    faces.append([int(x) for x in text[pos:pos + n]])
                    pos += n
                out["faces"] = np.asarray(faces, np.int64)
        return out

    offset = 0
    for name, count, props in elements:
        if name == "vertex":
            dt = []
            for p in props:
                assert p[0] != "list"
                dt.append((p[1], type_map[p[0]]))
            rec = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += rec.itemsize * count
            out["verts"] = np.stack(
                [rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
            names = [p[1] for p in props]
            if "nx" in names:
                out["normals"] = np.stack(
                    [rec["nx"], rec["ny"], rec["nz"]], -1).astype(np.float32)
            if "red" in names:
                out["colors"] = np.stack(
                    [rec["red"], rec["green"], rec["blue"]], -1)
        elif name == "face":
            lp = props[0]
            cnt_t = type_map[lp[1]]
            idx_t = type_map[lp[2]]
            cnt_size = np.dtype(cnt_t).itemsize
            idx_size = np.dtype(idx_t).itemsize
            # assume constant 3-index faces (what we write)
            rec = np.frombuffer(body, dtype=[("n", cnt_t), ("idx", idx_t, (3,))],
                                count=count, offset=offset)
            offset += rec.itemsize * count
            out["faces"] = rec["idx"].astype(np.int64)
    return out
