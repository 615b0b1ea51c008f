"""On-device binned reductions — the data-parallel replacement for the
reference apps' serial per-ray histogram loops (e.g. emissivity.cpp:96-126).

Everything is a masked segment-sum over the ray axis: rays outside the mask
are routed to a scrap bin. Under a sharded ray axis these compose with a
psum over the mesh to merge per-shard partials (see raytrace_tpu.parallel).
"""

from __future__ import annotations

import jax.numpy as jnp


def radial_bin_index(r, r_min, dr, n_bins, logbin: bool):
    """Bin index for radius r under the reference's binning convention
    (emissivity.cpp:59,105): log bins  ir = floor(log(r/r_min)/log(dr)),
    linear bins ir = floor((r - r_min)/dr)."""
    if logbin:
        ir = jnp.floor(jnp.log(r / r_min) / jnp.log(dr))
    else:
        ir = jnp.floor((r - r_min) / dr)
    return ir.astype(jnp.int32), (ir >= 0) & (ir < n_bins)


def bin_edges(r_min, r_max, n_bins, logbin: bool):
    """Left edges and widths matching the reference convention
    (emissivity.cpp:59,78): log bins r_i = r_min * dr^i with multiplicative
    width dr = exp(log(r_max/r_min)/Nr); linear r_i = r_min + i*dr."""
    i = jnp.arange(n_bins)
    if logbin:
        dr = jnp.exp(jnp.log(r_max / r_min) / n_bins)
        r = r_min * dr**i
        width = r * dr - r  # i.e. r*(dr-1): edge-to-edge coordinate width
    else:
        dr = (r_max - r_min) / n_bins
        r = r_min + i * dr
        width = jnp.full_like(r, dr)
    return r, width, dr


def masked_segment_sum(values, seg_ids, mask, n_bins):
    """Sum `values` into n_bins segments, dropping rays where mask is False."""
    ids = jnp.where(mask, seg_ids, n_bins)  # scrap bin
    out = jnp.zeros((n_bins + 1,), dtype=values.dtype).at[ids].add(
        jnp.where(mask, values, 0)
    )
    return out[:n_bins]


def radial_bin_profile(r, mask, weights: dict, r_min, dr, n_bins, logbin: bool):
    """Bin per-ray weights into radial bins.

    Returns (counts, {name: per-bin sum}) with the same bin convention as
    the reference emissivity app.
    """
    ids, in_range = radial_bin_index(r, r_min, dr, n_bins, logbin)
    m = mask & in_range
    counts = masked_segment_sum(jnp.ones_like(r), ids, m, n_bins)
    sums = {k: masked_segment_sum(v, ids, m, n_bins) for k, v in weights.items()}
    return counts, sums


def pixel_accumulate(ix, iy, mask, weights: dict, nx: int, ny: int):
    """Accumulate per-ray weights onto an (nx, ny) pixel grid.

    Replaces the reference image apps' per-ray `+=` into Array2D maps
    (imageplane_disc_image.cpp:122-176). Returns (counts, {name: image}).
    """
    in_range = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    m = mask & in_range
    flat = jnp.where(m, ix * ny + iy, nx * ny).astype(jnp.int32)

    def scatter(v):
        out = jnp.zeros((nx * ny + 1,), dtype=v.dtype).at[flat].add(jnp.where(m, v, 0))
        return out[: nx * ny].reshape(nx, ny)

    ones = jnp.ones(flat.shape, dtype=jnp.result_type(*(list(weights.values()) or [jnp.float64])))
    counts = scatter(ones)
    images = {k: scatter(v) for k, v in weights.items()}
    return counts, images
