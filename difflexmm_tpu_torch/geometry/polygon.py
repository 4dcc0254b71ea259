"""Batched polygon utilities on ``(..., V, 2)`` vertex tensors
(counter-clockwise). Counterpart of ``difflexmm_tpu/geometry/polygon.py``,
with the same operations in the same order."""

import torch


def _shoelace_cross(vertices: torch.Tensor) -> torch.Tensor:
    """Per-edge cross products v_{i-1} x v_i, shape (..., V)."""

    prev_v = torch.roll(vertices, shifts=1, dims=-2)
    return prev_v[..., 0] * vertices[..., 1] - prev_v[..., 1] * vertices[..., 0]


def polygon_area(vertices: torch.Tensor) -> torch.Tensor:
    """Area of each polygon. (..., V, 2) -> (...)."""

    return torch.abs(torch.sum(_shoelace_cross(vertices), dim=-1) / 2)


def polygon_centroid(vertices: torch.Tensor) -> torch.Tensor:
    """Centroid of each polygon. (..., V, 2) -> (..., 2)."""

    cross = _shoelace_cross(vertices)
    area = torch.sum(cross, dim=-1) / 2  # signed
    prev_v = torch.roll(vertices, shifts=1, dims=-2)
    sums = torch.sum((prev_v + vertices) * cross[..., None], dim=-2)
    return sums / (6 * area[..., None])


def polygon_polar_moment(vertices: torch.Tensor) -> torch.Tensor:
    """Polar second moment of area about the centroid. (..., V, 2) -> (...)."""

    centroid = polygon_centroid(vertices)
    v2 = vertices - centroid[..., None, :]
    v1 = torch.roll(v2, shifts=1, dims=-2)
    cross = v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]
    quad = (
        v1[..., 0] ** 2 + v1[..., 0] * v2[..., 0] + v2[..., 0] ** 2
        + v1[..., 1] ** 2 + v1[..., 1] * v2[..., 1] + v2[..., 1] ** 2
    )
    return torch.abs(torch.sum(cross * quad, dim=-1) / 12)


def compute_edge_lengths(centroid_node_vectors: torch.Tensor) -> torch.Tensor:
    """Edge lengths of each block polygon. (n_blocks, V, 2) -> (n_blocks, V)."""

    edges = torch.roll(centroid_node_vectors, 1, dims=-2) - centroid_node_vectors
    return torch.linalg.norm(edges, dim=-1)


def signed_angle(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Signed angle from u1 to u2 (counter-clockwise positive), (..., 2) ->
    (...) in [-pi, pi]."""

    cross = u1[..., 0] * u2[..., 1] - u1[..., 1] * u2[..., 0]
    dot = u1[..., 0] * u2[..., 0] + u1[..., 1] * u2[..., 1]
    return torch.atan2(cross, dot)


def compute_inertia(vertices: torch.Tensor, density) -> torch.Tensor:
    """(n_blocks, 3) inertia [m, m, J] of each block polygon; ``density``
    is a scalar or (n_blocks,)."""

    m = density * polygon_area(vertices)
    J = density * polygon_polar_moment(vertices)
    return torch.stack([m, m, J], dim=-1)
