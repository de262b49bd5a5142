"""Operations and bytes of the step, worked out from the configuration's
widths and the shapes the step ran, and the H100's peaks.

FLOPs count a multiply-add as two. Integer hashing, activations and the
composite's few operations a sample are not counted, so the counts are
lower bounds. A point that takes gradients counts three times its
forward (forward, and the two products of the backward).
"""
from __future__ import annotations

#: NVIDIA H100 SXM (data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def point_flops(opt) -> dict:
    """FLOPs of one point: ``enc`` the trilinear interpolation of every
    level, ``enc_grad`` its spatial Jacobian, ``geo`` the geometry MLP,
    ``geo_grad`` its input gradient and the normal, ``rad`` the radiance
    MLP (its input: point, 4-band Fourier view, normal, feature)."""
    hc = opt["SDF"]["Hash_config"]
    L, F = hc["n_levels"], hc["n_features_per_level"]
    D = 3 + L * F
    g = list(opt["SDF"]["arch"]["layers"])
    dims = [D] + g[1:-1] + [g[-1] + 1]
    geo = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    geo_grad = sum(2 * a * b for a, b in zip(dims[:-2], dims[1:-1])) + 2 * D * 3
    r = list(opt["RadF"]["arch"]["layers"])
    rdims = [3 + 27 + 3 + g[-1]] + r[1:]
    rad = sum(2 * a * b for a, b in zip(rdims[:-1], rdims[1:]))
    return {"enc": L * (16 + 16 * F), "enc_grad": L * (72 + 48 * F), "geo": geo,
            "geo_grad": geo_grad, "rad": rad}


def step_flops(opt, render_points, march_points, reeval_points, surface_points,
               occ_points) -> float:
    """FLOPs of the work the step did: ``render_points`` (rays x the
    compacted samples: SDF, normal and radiance, with gradients),
    ``march_points`` (SDF only, no gradient), ``reeval_points`` (SDF with
    gradients), ``surface_points`` (BA's track points: SDF and normal,
    then the SDF again, with gradients) and ``occ_points`` (the occupancy
    grid's share of this step: SDF only)."""
    p = point_flops(opt)
    sdf = p["enc"] + p["geo"]
    full = sdf + p["enc_grad"] + p["geo_grad"]
    return (3.0 * (render_points * (full + p["rad"]) + reeval_points * sdf
                   + surface_points * (full + sdf))
            + (march_points + occ_points) * sdf)


def scatter_bytes(n, m, F) -> int:
    """The ordered scatter of n contributions into m rows of F float32
    features: an 8-byte key and the cotangent read a contribution, a row
    written once."""
    return n * (8 + 4 * F) + m * 4 * F


def composite_bytes(R, K):
    """(forward, backward) bytes of the fused composite over R rays of K
    samples: each input read once, each output written once. A sample:
    sdf, depth 4 B, valid 1 B, rgb, normal 12 B; a ray: delta 4 B; alpha,
    beta 8 B; the forward writes 8 floats a ray; the backward reads 8
    floats of cotangents a ray and writes 8 floats a sample, d_delta a
    float a ray and d_alpha, d_beta."""
    inputs = R * K * 33 + 4 * R + 8
    return inputs + 32 * R, inputs + 32 * R + 32 * R * K + 4 * R + 8
