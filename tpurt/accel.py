"""Host-side BVH construction (NumPy) with an optional native C++ builder.

Algorithm parity with the reference builder (ref: src/instance.rs:175-310):
recursive median split on the longest *centroid*-bounds axis, leaves hold at
most `max_prims` triangles, empty meshes produce a single zeroed node.  The
flat node layout is {bbox_min, bbox_max, left, right, first, count}; a node
is a leaf iff count > 0.

Deviation: instead of storing a tri_indices indirection table
(reference: bvh_triangle_indices), we return `order`, the permutation of
triangles into leaf order.  The caller permutes the triangle SoA arrays once
at build time, so device traversal reads contiguous [first, first+count)
ranges with zero indirection — one less gather per leaf triangle.

An iterative explicit stack replaces recursion (Python recursion depth and
call overhead both hurt at 100k+ triangles); the splits and leaf contents are
identical to the reference's depth-first recursion, only the internal node
numbering differs (children are allocated eagerly rather than per-subtree).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BVH:
    bbox_min: np.ndarray  # (B, 3) f32
    bbox_max: np.ndarray  # (B, 3) f32
    left: np.ndarray      # (B,) i32
    right: np.ndarray     # (B,) i32
    first: np.ndarray     # (B,) i32
    count: np.ndarray     # (B,) i32
    order: np.ndarray     # (T,) i32 — triangle permutation into leaf order


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, max_prims: int = 2,
              sah: bool = False) -> BVH:
    """Build a BVH from per-triangle AABBs.

    tri_min/tri_max: (T, 3) float arrays. max_prims >= 1 triangles per leaf.

    sah=False (default): the reference's median split (instance.rs:160-310).
    Uses the native C++ builder when native/libtpurt_native.so is present
    (identical output — see tests/test_native.py); NumPy otherwise.

    sah=True: binned surface-area-heuristic splits (native C++ when built,
    bit-identical NumPy fallback — see tests/test_native.py). Same node
    layout and leaf-order contract; only the split positions differ, so the
    tree is a drop-in for every traversal. The cost model is a fixed-width
    leaf sweep (`max_prims` records regardless of occupancy): leaf cost is
    ceil(n / max_prims) sweep units weighted by box surface area, so the
    heuristic packs leaves full AND cuts overlap.
    """
    max_prims = max(int(max_prims), 1)
    T = int(tri_min.shape[0])
    if sah and T > 0:
        from tpurt.utils.native import build_bvh_native
        nat = build_bvh_native(np.asarray(tri_min, np.float32),
                               np.asarray(tri_max, np.float32), max_prims,
                               sah=True)
        bvh = BVH(*nat) if nat is not None else _build_bvh_py(
            np.asarray(tri_min, np.float32),
            np.asarray(tri_max, np.float32), max_prims, sah=True)
        # Lopsided SAH splits can mint many under-full leaves. Hold SAH
        # trees to the median build's < 2*ceil(T/K) node envelope (callers
        # size node tables by it); past it, take the guaranteed-balanced
        # median tree instead.
        if bvh.bbox_min.shape[0] <= 2 * max(1, -(-T // max_prims)):
            return bvh
        sah = False
    if T > 0:
        from tpurt.utils.native import build_bvh_native
        nat = build_bvh_native(np.asarray(tri_min, np.float32),
                               np.asarray(tri_max, np.float32), max_prims)
        if nat is not None:
            return BVH(*nat)
    return _build_bvh_py(tri_min, tri_max, max_prims, sah=False)


_SAH_BINS = 16
# Past this depth an SAH subtree switches to median splits: median halving
# bounds the remaining depth by log2(n), keeping the deepest possible tree
# well inside a 64-deep traversal stack.
_SAH_DEPTH_CAP = 40


# The "always visited" floor in the split cost, as a fraction of the ROOT
# box area: a traversal that visits a node when ANY ray of a group votes
# for it pays one full leaf sweep almost regardless of the box area. The
# floor steers the heuristic toward FEWER (fuller) leaves when area
# differences are small; pure per-ray SAH is the alpha -> 0 limit. The
# native builder (native/tpurt_native.cpp) uses the same constant.
_SAH_FLOOR = 0.25


def _leaf_area_cost(lo, hi, n, max_prims, floor):
    d = np.maximum(hi - lo, 0.0)
    area = d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]
    return (area + floor) * -(-n // max_prims)


def _sah_split(tri_min, tri_max, centroid, idx, max_prims, floor):
    """Best binned-SAH split of `idx`: returns (left_idx, right_idx) or
    None when the median split scores at least as well under the same cost
    model (or every candidate is degenerate), in which case the caller
    median-splits — SAH is never worse than median under the model."""
    c = centroid[idx]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    ext = cmax - cmin
    best_cost, best, best_b = np.inf, None, None
    for dim in range(3):
        if ext[dim] <= 0.0:
            continue
        b = np.minimum((_SAH_BINS * (c[:, dim] - cmin[dim]) / ext[dim])
                       .astype(np.int64), _SAH_BINS - 1)
        counts = np.bincount(b, minlength=_SAH_BINS)
        bmin = np.full((_SAH_BINS, 3), np.inf, np.float64)
        bmax = np.full((_SAH_BINS, 3), -np.inf, np.float64)
        np.minimum.at(bmin, b, tri_min[idx])
        np.maximum.at(bmax, b, tri_max[idx])
        # prefix/suffix boxes give every plane's child areas in one sweep
        lmin, lmax = np.minimum.accumulate(bmin), np.maximum.accumulate(bmax)
        rmin = np.minimum.accumulate(bmin[::-1])[::-1]
        rmax = np.maximum.accumulate(bmax[::-1])[::-1]
        nl = np.cumsum(counts)[:-1]
        nr = len(idx) - nl
        valid = (nl > 0) & (nr > 0)
        if not valid.any():
            continue
        cost = np.where(
            valid,
            _leaf_area_cost(lmin[:-1], lmax[:-1], nl, max_prims, floor)
            + _leaf_area_cost(rmin[1:], rmax[1:], nr, max_prims, floor),
            np.inf)
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost, best, best_b = float(cost[k]), (dim, k), b
    if best is None:
        return None

    # Median candidate under the SAME cost model: take SAH only if it wins.
    dmed = 0 if (ext[0] >= ext[1] and ext[0] >= ext[2]) else (
        1 if ext[1] >= ext[2] else 2)
    srt = np.argsort(c[:, dmed], kind="stable")
    mid = len(idx) // 2
    lo, hi = srt[:mid], srt[mid:]
    med_cost = float(
        _leaf_area_cost(tri_min[idx[lo]].min(0), tri_max[idx[lo]].max(0),
                        mid, max_prims, floor)
        + _leaf_area_cost(tri_min[idx[hi]].min(0), tri_max[idx[hi]].max(0),
                          len(idx) - mid, max_prims, floor))
    if med_cost <= best_cost:
        return None

    _, k = best
    go_left = best_b <= k
    return idx[go_left], idx[~go_left]


def _build_bvh_py(tri_min: np.ndarray, tri_max: np.ndarray, max_prims: int,
                  sah: bool) -> BVH:
    T = int(tri_min.shape[0])
    if T == 0:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros((1,), np.int32)
        return BVH(z3, z3, zi, zi, zi, zi, np.zeros((0,), np.int32))

    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    centroid = 0.5 * tri_min + 0.5 * tri_max

    nodes_min, nodes_max = [], []
    nodes_left, nodes_right, nodes_first, nodes_count = [], [], [], []
    order: list[int] = []

    # Depth-first build with an explicit stack of (node_idx, index_array)
    # entries: each pop allocates/splits its node in a single visit and the
    # PARENT writes its children's indices (left = next alloc, right after
    # the left subtree), reproducing the reference's recursive control flow
    # and leaf order exactly.
    def alloc():
        nodes_min.append(np.zeros(3, np.float32))
        nodes_max.append(np.zeros(3, np.float32))
        nodes_left.append(0)
        nodes_right.append(0)
        nodes_first.append(0)
        nodes_count.append(0)
        return len(nodes_min) - 1

    if sah:
        d = np.maximum(tri_max.max(axis=0).astype(np.float64)
                       - tri_min.min(axis=0), 0.0)
        floor = _SAH_FLOOR * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
    root = alloc()
    stack = [(root, np.arange(T, dtype=np.int64), 0)]
    # Pushing right-then-left pops the left subtree first, so leaf triangles
    # land in `order` in the reference's depth-first left-to-right sequence.
    while stack:
        node, idx, depth = stack.pop()
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        nodes_min[node] = bmin
        nodes_max[node] = bmax
        n = len(idx)
        if n <= max_prims:
            nodes_first[node] = len(order)
            nodes_count[node] = n
            order.extend(idx.tolist())
            continue

        split = None
        if sah and depth < _SAH_DEPTH_CAP:
            split = _sah_split(tri_min, tri_max, centroid, idx, max_prims,
                               floor)
        if split is None:
            c = centroid[idx]
            cmin, cmax = c.min(axis=0), c.max(axis=0)
            d = cmax - cmin
            # Longest-axis rule with the reference's >= tie-breaking
            # (x wins ties with y and z; y wins ties with z).
            # instance.rs:167-172.
            if d[0] >= d[1] and d[0] >= d[2]:
                dim = 0
            elif d[1] >= d[2]:
                dim = 1
            else:
                dim = 2
            srt = idx[np.argsort(c[:, dim], kind="stable")]
            split = (srt[:n // 2], srt[n // 2:])

        lchild = alloc()
        rchild = alloc()
        nodes_left[node] = lchild
        nodes_right[node] = rchild
        # Push right first so left is processed (and numbered) first.
        stack.append((rchild, split[1], depth + 1))
        stack.append((lchild, split[0], depth + 1))

    return BVH(
        bbox_min=np.stack(nodes_min).astype(np.float32),
        bbox_max=np.stack(nodes_max).astype(np.float32),
        left=np.asarray(nodes_left, np.int32),
        right=np.asarray(nodes_right, np.int32),
        first=np.asarray(nodes_first, np.int32),
        count=np.asarray(nodes_count, np.int32),
        order=np.asarray(order, np.int32),
    )


def validate_bvh(bvh: BVH, tri_min: np.ndarray, tri_max: np.ndarray, eps=1e-5) -> None:
    """Structural invariants: every triangle in exactly one leaf; parent boxes
    contain child boxes; leaf boxes contain their triangles. Raises on breach."""
    T = tri_min.shape[0]
    if T == 0:
        return
    seen = np.sort(bvh.order)
    if not np.array_equal(seen, np.arange(T)):
        raise AssertionError("BVH leaf order is not a permutation of triangles")
    B = bvh.bbox_min.shape[0]
    for i in range(B):
        if bvh.count[i] > 0:
            f, c = int(bvh.first[i]), int(bvh.count[i])
            tris = bvh.order[f:f + c]
            if (tri_min[tris] < bvh.bbox_min[i] - eps).any() or (tri_max[tris] > bvh.bbox_max[i] + eps).any():
                raise AssertionError(f"leaf {i} does not contain its triangles")
        else:
            for ch in (int(bvh.left[i]), int(bvh.right[i])):
                if ch == 0 and i != 0:
                    raise AssertionError(f"inner node {i} has null child")
                if (bvh.bbox_min[ch] < bvh.bbox_min[i] - eps).any() or (bvh.bbox_max[ch] > bvh.bbox_max[i] + eps).any():
                    raise AssertionError(f"node {i} does not contain child {ch}")
