"""Minimal PLY mesh reader (the JAX package's ``data/plyio.py``; it
replaces trimesh.load for the FHB object models, reference:
handobjectdatasets/fhbutils.py:8-21).

Supports ascii and binary_little_endian PLY with vertex x/y/z properties and
list-typed face indices; other properties are parsed and skipped.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    """Returns (vertices (V,3) float64, faces (F,3) int64)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        elements = []  # (name, count, [(prop_name, dtype, is_list, idx_t, cnt_t)])
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property" and elements:
                if parts[1] == "list":
                    elements[-1][2].append(
                        (parts[4], None, True, _TYPES[parts[2]], _TYPES[parts[3]])
                    )
                else:
                    elements[-1][2].append(
                        (parts[2], _TYPES[parts[1]], False, None, None)
                    )

        verts, faces = None, None
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = [p[0] for p in props]
                    xi, yi, zi = cols.index("x"), cols.index("y"), cols.index("z")
                    verts = np.array(
                        [[float(r[xi]), float(r[yi]), float(r[zi])] for r in rows]
                    )
                elif name == "face":
                    out = []
                    for r in rows:
                        n = int(r[0])
                        ids = list(map(int, r[1 : 1 + n]))
                        for k in range(1, n - 1):
                            out.append([ids[0], ids[k], ids[k + 1]])
                    faces = np.asarray(out, np.int64)
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if not any(p[2] for p in props):
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dt)
                    if name == "vertex":
                        verts = np.stack(
                            [data["x"], data["y"], data["z"]], axis=1
                        ).astype(np.float64)
                else:
                    out = []
                    for _ in range(count):
                        scalars = {}
                        for pname, pdt, is_list, cnt_t, idx_t in props:
                            if is_list:
                                cnt_dt = np.dtype("<" + cnt_t)
                                n = int(
                                    np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0]
                                )
                                idx_dt = np.dtype("<" + idx_t)
                                ids = np.frombuffer(
                                    f.read(idx_dt.itemsize * n), idx_dt
                                ).tolist()
                                if pname in ("vertex_indices", "vertex_index"):
                                    for k in range(1, n - 1):
                                        out.append([ids[0], ids[k], ids[k + 1]])
                            else:
                                dt = np.dtype("<" + pdt)
                                scalars[pname] = np.frombuffer(
                                    f.read(dt.itemsize), dt
                                )[0]
                    if name == "face":
                        faces = np.asarray(out, np.int64)
        else:
            raise ValueError(f"Unsupported PLY format {fmt}")
    if verts is None:
        raise ValueError(f"No vertex element in {path}")
    return verts, faces
