"""Minimal PLY mesh / point-cloud IO (numpy only).

Replaces the reference's dependencies on ``plyfile`` (reading pseudo point
clouds, dtu.py:435) and ``trimesh``'s exporter (writing validation meshes,
runner.py:240).  Supports ascii and binary_little_endian, float/double
vertex properties and uchar-counted int vertex_indices.
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Read a PLY file.

    Returns dict with 'vertices' (n,3) float64 and, when present, 'faces'
    (m,3) int64 plus any extra vertex properties under 'vertex_data'.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype) or ('list', idx_dtype, val_dtype, name)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.decode("ascii").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment":
                continue
            elif tokens[0] == "element":
                cur = {"name": tokens[1], "count": int(tokens[2]), "props": []}
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur["props"].append(("list", _DTYPES[tokens[2]], _DTYPES[tokens[3]], tokens[4]))
                else:
                    cur["props"].append((tokens[2], _DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        out = {"vertex_data": {}}
        if fmt == "ascii":
            for el in elements:
                rows = [f.readline().split() for _ in range(el["count"])]
                _parse_element_ascii(el, rows, out)
        elif fmt == "binary_little_endian":
            for el in elements:
                _parse_element_binary(el, f, out, "<")
        elif fmt == "binary_big_endian":
            for el in elements:
                _parse_element_binary(el, f, out, ">")
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return out


def _parse_element_ascii(el, rows, out):
    if el["name"] == "vertex":
        names = [p[0] for p in el["props"]]
        arr = np.array([[float(v) for v in r] for r in rows], dtype=np.float64)
        for i, n in enumerate(names):
            out["vertex_data"][n] = arr[:, i]
        out["vertices"] = np.stack([out["vertex_data"][k] for k in ("x", "y", "z")], axis=1)
    elif el["name"] == "face":
        faces = [[int(v) for v in r[1:1 + int(r[0])]] for r in rows]
        out["faces"] = np.array(faces, dtype=np.int64)


def _parse_element_binary(el, f, out, endian):
    simple = all(p[0] != "list" for p in el["props"])
    if simple:
        dt = np.dtype([(p[0], endian + p[1]) for p in el["props"]])
        data = np.frombuffer(f.read(dt.itemsize * el["count"]), dtype=dt)
        if el["name"] == "vertex":
            for n in dt.names:
                out["vertex_data"][n] = np.asarray(data[n])
            out["vertices"] = np.stack([np.asarray(data[k], dtype=np.float64)
                                        for k in ("x", "y", "z")], axis=1)
        return
    # list properties (faces): assume single list property
    (tag, idx_dt, val_dt, name), = [p for p in el["props"] if p[0] == "list"]
    idx_size = np.dtype(idx_dt).itemsize
    val_size = np.dtype(val_dt).itemsize
    faces = []
    # fast path: fixed triangle count
    raw = f.read()
    pos = 0
    for _ in range(el["count"]):
        n = int(np.frombuffer(raw, dtype=endian + idx_dt, count=1, offset=pos)[0])
        pos += idx_size
        vals = np.frombuffer(raw, dtype=endian + val_dt, count=n, offset=pos)
        pos += n * val_size
        faces.append(vals)
    if faces and all(len(x) == 3 for x in faces):
        out["faces"] = np.array(faces, dtype=np.int64)
    else:
        out["faces_list"] = faces
    # push back unread bytes for subsequent elements
    f.seek(-(len(raw) - pos), 1)


def write_ply(path, vertices, faces=None, *, vertex_colors=None, binary=True):
    """Write a triangle mesh (or point cloud when faces is None)."""
    vertices = np.asarray(vertices, dtype=np.float32)
    n = len(vertices)
    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        vertex_colors = np.asarray(vertex_colors, dtype=np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32)
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if vertex_colors is None:
                f.write(vertices.astype("<f4").tobytes())
            else:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("r", "u1"), ("g", "u1"), ("b", "u1")])
                rec = np.empty(n, dtype=dt)
                rec["x"], rec["y"], rec["z"] = vertices.T
                rec["r"], rec["g"], rec["b"] = vertex_colors.T
                f.write(rec.tobytes())
            if faces is not None:
                dt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
                rec = np.empty(len(faces), dtype=dt)
                rec["n"] = 3
                rec["a"], rec["b"], rec["c"] = faces.T
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = " ".join(f"{v:.6f}" for v in vertices[i])
                if vertex_colors is not None:
                    row += " " + " ".join(str(int(v)) for v in vertex_colors[i])
                f.write((row + "\n").encode("ascii"))
            if faces is not None:
                for tri in faces:
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))
