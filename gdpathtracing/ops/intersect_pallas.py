"""Closest-hit and occlusion kernels over the expanded triangle list
(Pallas, ``backend="triton"``).

Same unit-triangle-space math as render/intersect.py:trace_unit, fused so
the (rays × triangles) intermediates live in registers: a program owns a
block of ``BN`` rays and sweeps ``BT``-triangle sub-tiles with explicit f32
FMAs (no ``dot``: K = 4 is far below what a tensor-core product takes, and
a ``dot`` would round through TF32). Only the rays and the (16, E) unit
rows are read; (t, eidx, steps) — or one occlusion flag — are written.

Culling is two-level. Triangles are Morton-sorted into 256-triangle chunks
(scene.ISECT_CHUNK) and ``SCC`` chunks form a superchunk. XLA builds, per
ray block, the near-to-far list of superchunks some ray of the block may
enter (``_block_queue``). Inside the kernel a ``while_loop`` walks that
list; a superchunk, and then each of its chunks, is swept only when the
per-ray slab test passes for some ray of the block and can still beat that
ray's current best.

Results do not depend on block composition: a ray takes a hit only from
chunks its own (inflated) slab test passed, and exact-t ties resolve to
the lowest expanded-triangle index whatever the visit order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gdpathtracing.render.types import MISS_T, HitInfo, Ray
from gdpathtracing.scene.scene import ISECT_CHUNK, Scene

# Block sizes: the best of a (rays, triangles, warps) sweep on an H100 at
# 2^20 camera and random rays on the demo and grid scenes (PERF.md). Small
# ray blocks cull better on incoherent rays; a 32×32 tile keeps the ~10
# live (BN, BT) f32 intermediates in registers at 2 warps.
BN = 32          # rays per program
BT = 32          # triangles per register sub-tile (CHUNK is swept in these)
NUM_WARPS = 2
CHUNK = ISECT_CHUNK  # culling unit: chunk AABBs come with the scene
SCC = 8          # chunks per superchunk (the unit of the per-block queue)
TRI_ROWS = 16    # mu(4) | mv(4) | mw(4) | zero pad to a power of two
_WD_EPS = 1e-12
_MISS = 1e9      # python float: a jnp constant would become a kernel const


def _interpret() -> bool:
    """Pallas interpret mode exactly when JAX runs on the CPU: the kernels
    compile for the GPU and are interpreted only where there is none."""
    return jax.default_backend() == "cpu"


def _rcp(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)


def _slab(lo, hi, o, rd):
    """Slab test of rays against one box → (tmin, tmax) per ray.
    `lo`/`hi`: 3 scalars each; `o`/`rd`: 3 per-ray arrays each."""
    t1 = [(lo[a] - o[a]) * rd[a] for a in range(3)]
    t2 = [(hi[a] - o[a]) * rd[a] for a in range(3)]
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1[0], t2[0]),
                                   jnp.minimum(t1[1], t2[1])),
                       jnp.minimum(t1[2], t2[2]))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1[0], t2[0]),
                                   jnp.maximum(t1[1], t2[1])),
                       jnp.maximum(t1[2], t2[2]))
    return tmin, tmax


def _any(mask):
    # Triton lowers no boolean or-reduction; an i32 max is the same test.
    return jnp.max(mask.astype(jnp.int32)) > 0


def _kernel(rays_ref, tri_ref, cb_ref, sb_ref, q_ref, nq_ref, *out_refs,
            any_hit):
    """One program = one block of rays. Closest hit writes (t, eidx,
    steps); any-hit writes one i32 occlusion flag per ray."""
    i = pl.program_id(0)
    o = [rays_ref[k, :] for k in range(3)]
    d = [rays_ref[3 + k, :] for k in range(3)]
    tlim = rays_ref[6, :]  # per-ray tmax (any-hit only)
    rd = [_rcp(x) for x in d]
    nq = nq_ref[i]
    zi = (o[0] * 0.0).astype(jnp.int32)

    def gate(ref, c, st):
        """Per-ray test of box c of `ref`: may the ray hit inside it, and
        still improve (closest hit) or still be unresolved (any-hit)?"""
        lo = [ref[k, c] for k in range(3)]
        hi = [ref[3 + k, c] for k in range(3)]
        tmin, tmax = _slab(lo, hi, o, rd)
        if any_hit:
            return ((tmax >= tmin) & (tmax > 0.0) & (tmin < tlim)
                    & (st[0] == 0))
        return (tmax >= tmin) & (tmax > 0.0) & (tmin <= st[0])

    def tile(k, st, g, may):
        """Sweep sub-tile k of chunk g (BT triangles) against the block."""
        off = pl.multiple_of(g * CHUNK + k * BT, BT)
        m = [tri_ref[r, pl.ds(off, BT)][None, :] for r in range(12)]
        oc = [x[:, None] for x in o]
        dc = [x[:, None] for x in d]

        def row(c):  # (o, 1)·m[c] and (d, 0)·m[c] as explicit FMAs
            a = oc[0] * m[c] + oc[1] * m[c + 1] + oc[2] * m[c + 2] + m[c + 3]
            b = dc[0] * m[c] + dc[1] * m[c + 1] + dc[2] * m[c + 2]
            return a, b

        u_o, u_d = row(0)
        v_o, v_d = row(4)
        w_o, w_d = row(8)
        wd_ok = jnp.abs(w_d) > _WD_EPS
        t = -w_o / jnp.where(wd_ok, w_d, 1.0)
        u = u_o + t * u_d
        v = v_o + t * v_d
        valid = wd_ok & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        if any_hit:
            blocked = valid & (t < tlim[:, None]) & may[:, None]
            return (st[0] | jnp.max(blocked.astype(jnp.int32), axis=1),)
        best_t, best_e, steps = st
        t = jnp.where(valid, t, _MISS)
        tk = jnp.min(t, axis=1)
        e = off + jnp.argmin(t, axis=1).astype(jnp.int32)
        # Lexicographic (t, eidx) winner: argmin already takes the lowest
        # index inside the tile; the second clause settles exact-t ties
        # across tiles and chunks, whatever their visit order.
        better = ((tk < best_t)
                  | ((tk == best_t) & (tk < _MISS) & (e < best_e))) & may
        return (jnp.where(better, tk, best_t), jnp.where(better, e, best_e),
                steps)

    def chunk(c, st, s):
        g = s * SCC + c
        may = gate(cb_ref, g, st)

        def sweep(st):
            if not any_hit:  # steps: triangles swept for the ray
                st = st[:2] + (st[2] + jnp.where(may, CHUNK, 0),)
            return jax.lax.fori_loop(
                0, CHUNK // BT, lambda k, s_: tile(k, s_, g, may), st)

        return jax.lax.cond(_any(may), sweep, lambda st: st, st)

    def cond(carry):
        j, st = carry
        more = j < nq
        if any_hit:  # stop once every ray of the block is resolved
            more = more & _any(st[0] == 0)
        return more

    def body(carry):
        j, st = carry
        s = q_ref[i, j]
        st = jax.lax.cond(
            _any(gate(sb_ref, s, st)),
            lambda st: jax.lax.fori_loop(
                0, SCC, lambda c, s_: chunk(c, s_, s), st),
            lambda st: st, st)
        return j + 1, st

    if any_hit:
        st0 = (zi,)
    else:
        st0 = (o[0] * 0.0 + _MISS, zi, zi)
    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st0))
    for ref, val in zip(out_refs, st):
        ref[...] = val


def _block_queue(rays, sb):
    """Per-block near-to-far superchunk queue, built in XLA.

    Returns (queue (nb, nsc) i32, count (nb,) i32): the first `count`
    entries of a block's row are the superchunks some ray of the block may
    enter (conservative slab test, inside its tmax), ordered by the
    block-minimum entry distance — front to back, so the kernel's
    `tmin <= best` cut fires early. Parked rays (origin 1e9) enter none."""
    nb = rays.shape[1] // BN
    o = [rays[k] for k in range(3)]
    rd = [_rcp(rays[3 + k]) for k in range(3)]
    tlim = rays[6]
    keys = []
    for s in range(sb.shape[1]):
        tmin, tmax = _slab(sb[0:3, s], sb[3:6, s], o, rd)
        slack = 1e-5 * jnp.abs(tmax) + 1e-6
        ok = (tmax + slack >= tmin) & (tmax > -1e-6) & (tmin < tlim + slack)
        key = jnp.where(ok, jnp.maximum(tmin, 0.0), jnp.inf)
        keys.append(jnp.min(key.reshape(nb, BN), axis=1))
    key = jnp.stack(keys, axis=1)
    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    return order, jnp.sum(jnp.isfinite(key), axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("any_hit",))
def _trace_call(rays, tri, cb, sb, *, any_hit):
    """rays: (8, N) [o | d | tmax | 0], N % BN == 0. Closest hit →
    (t f32, eidx i32, steps i32); any-hit → (occluded i32,)."""
    n = rays.shape[1]
    queue, count = _block_queue(rays, sb)
    ray_spec = pl.BlockSpec((8, BN), lambda i: (0, i))
    out_spec = pl.BlockSpec((BN,), lambda i: (i,))
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((n,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((n,), jnp.float32),
                     jax.ShapeDtypeStruct((n,), jnp.int32),
                     jax.ShapeDtypeStruct((n,), jnp.int32)]
    return pl.pallas_call(
        functools.partial(_kernel, any_hit=any_hit),
        grid=(n // BN,),
        in_specs=[ray_spec] + [pl.no_block_spec] * 5,
        out_specs=[out_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=_interpret(),
        name="occlusion" if any_hit else "closest_hit",
    )(rays, tri, cb, sb, queue, count)


class TracePrep(NamedTuple):
    """Kernel-ready scene tables (build once per traced program with
    prepare_trace_inputs; cheap E-sized work)."""
    tri: jnp.ndarray       # (16, E_pad) unit rows mu | mv | mw | 0
    cb: jnp.ndarray        # (8, nc_pad) inflated chunk bounds
    sb: jnp.ndarray        # (8, nsc) inflated superchunk bounds
    tri_inst: jnp.ndarray  # (E, 2) i32 [tri | inst] for the epilogue


def _inflate_bounds(cb):
    """(8, n) bounds → slightly inflated copy. A ray whose triangle hit the
    sweep would find must pass its OWN slab test (the per-ray merge gate);
    ~100 ulp of slack absorbs the rounding between the slab arithmetic and
    exact containment. Conservative: sweeps can only fire more often."""
    lo, hi, pad = cb[0:3], cb[3:6], cb[6:8]
    eps = 1e-5 * jnp.maximum(jnp.abs(lo), jnp.abs(hi)) + 1e-6
    return jnp.concatenate([lo - eps, hi + eps, pad], axis=0)


def prepare_trace_inputs(scene: Scene) -> TracePrep:
    """Pad the scene's chunk list to whole superchunks and assemble the
    kernel tables. Pad chunks get a point box at 1e30, which no slab test
    passes; pad triangles have zero rows, which never hit."""
    e = scene.isect_mu.shape[1]
    nc = e // CHUNK
    nc_pad = -(-nc // SCC) * SCC
    e_pad = nc_pad * CHUNK
    tri = jnp.concatenate([scene.isect_mu, scene.isect_mv, scene.isect_mw,
                           jnp.zeros((TRI_ROWS - 12, e), jnp.float32)])
    tri = jnp.pad(tri, ((0, 0), (0, e_pad - e)))
    pad_box = jnp.concatenate([jnp.full((6, nc_pad - nc), 1e30, jnp.float32),
                               jnp.zeros((2, nc_pad - nc), jnp.float32)])
    cb = jnp.concatenate([scene.isect_chunk_bounds, pad_box], axis=1)
    # Superchunk bounds from real chunks only (pad boxes would inflate).
    nsc = nc_pad // SCC
    real = (jnp.arange(nc_pad) < nc)[None, :]
    lo = jnp.where(real, cb[0:3], jnp.inf).reshape(3, nsc, SCC).min(axis=2)
    hi = jnp.where(real, cb[3:6], -jnp.inf).reshape(3, nsc, SCC).max(axis=2)
    sb = jnp.concatenate([lo, hi, jnp.zeros((2, nsc), jnp.float32)])
    return TracePrep(tri, _inflate_bounds(cb), _inflate_bounds(sb),
                     jnp.stack([scene.isect_tri, scene.isect_inst], axis=1))


def _pack_rays(ray: Ray, active, tmax):
    """(8, N_pad) kernel ray rows. Inactive and pad rays are parked far
    outside the scene on a diagonal, so every slab test fails."""
    n = ray.o.x.shape[0]
    n_pad = -(-n // BN) * BN
    far, s3 = 1e9, 0.5773503
    comps = [ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z]
    tm = ray.o.x * 0.0 + _MISS if tmax is None else tmax
    if active is not None:
        comps = ([jnp.where(active, c, far) for c in comps[:3]]
                 + [jnp.where(active, c, s3) for c in comps[3:]])
        tm = jnp.where(active, tm, 0.0)
    fill = [far, far, far, s3, s3, s3, 0.0]
    rows = [jnp.pad(c, (0, n_pad - n), constant_values=f)
            for c, f in zip(comps + [tm], fill)]
    return jnp.stack(rows + [rows[0] * 0.0])


def closest_hit(prep: TracePrep, ray: Ray, active=None):
    """Kernel closest hit → (t, eidx, steps), each (N,). t = MISS_T on a
    miss or an inactive ray."""
    n = ray.o.x.shape[0]
    t, e, steps = _trace_call(_pack_rays(ray, active, None), prep.tri,
                              prep.cb, prep.sb, any_hit=False)
    return t[:n], e[:n], steps[:n]


def _epilogue(scene: Scene, prep: TracePrep, ray: Ray, t, eidx,
              recompute_t: bool) -> HitInfo:
    """Winner u/v/front/tri/inst from (t, eidx): one (N, 12) isect_cols
    row and one (N, 2) tri_inst row per ray, plus 4-term dots. With
    `recompute_t` t is recomputed from the live rows too, so gradients
    reach geometry and camera through it."""
    hit = t < MISS_T
    eidx = jnp.where(hit, eidx, 0)
    rows = scene.isect_cols[eidx]

    def dot4(c0, p, w):
        return (rows[:, c0] * p.x + rows[:, c0 + 1] * p.y
                + rows[:, c0 + 2] * p.z + rows[:, c0 + 3] * w)

    one = ray.o.x * 0.0 + 1.0
    zero = ray.o.x * 0.0
    w_d = dot4(8, ray.d, zero)
    if recompute_t:
        inv_wd = jnp.where(jnp.abs(w_d) > _WD_EPS, w_d,
                           jnp.where(w_d < 0, -_WD_EPS, _WD_EPS))
        t = jnp.where(hit, -dot4(8, ray.o, one) / inv_wd, MISS_T)
    u = dot4(0, ray.o, one) + t * dot4(0, ray.d, zero)
    v = dot4(4, ray.o, one) + t * dot4(4, ray.d, zero)
    ti = prep.tri_inst[eidx]
    return HitInfo(t=t, tri=jnp.where(hit, ti[:, 0], 0),
                   inst=jnp.where(hit, ti[:, 1], 0),
                   u=jnp.clip(u, 0.0, 1.0), v=jnp.clip(v, 0.0, 1.0),
                   front=w_d < 0.0, steps=zero.astype(jnp.int32), eidx=eidx)


def trace_pallas(scene: Scene, ray: Ray, active=None,
                 prep: TracePrep | None = None) -> HitInfo:
    """Closest-hit HitInfo through the kernel. Pass a `prep`
    (prepare_trace_inputs) to hoist table assembly out of bounce loops."""
    if prep is None:
        prep = prepare_trace_inputs(scene)
    t, eidx, steps = closest_hit(prep, ray, active)
    return _epilogue(scene, prep, ray, t, eidx, False)._replace(steps=steps)


def trace_pallas_diff(scene: Scene, ray: Ray, active=None,
                      prep: TracePrep | None = None) -> HitInfo:
    """Differentiable closest hit: the kernel runs as a primal hit finder
    on stop-gradient inputs (autodiff never meets the Pallas call), and
    (t, u, v) of the winner are recomputed differentiably from the live
    ``scene.isect_cols`` — so gradients reach materials through shading
    and geometry/camera through the recomputed t, u, v."""
    sg = jax.lax.stop_gradient
    if prep is None:
        prep = prepare_trace_inputs(sg(scene))
    t, eidx, steps = closest_hit(
        jax.tree.map(sg, prep), Ray(sg(ray.o), sg(ray.d)),
        None if active is None else sg(active))
    return _epilogue(scene, prep, ray, t, eidx, True)._replace(steps=steps)


def occluded_pallas(scene: Scene, ray: Ray, t_max, active=None,
                    prep: TracePrep | None = None) -> jnp.ndarray:
    """Any-hit query: True where something blocks `ray` before `t_max`.
    Visibility is a step function of the inputs, so the kernel always sees
    stop-gradient inputs."""
    sg = jax.lax.stop_gradient
    if prep is None:
        prep = prepare_trace_inputs(sg(scene))
    n = ray.o.x.shape[0]
    (occ,) = _trace_call(
        _pack_rays(Ray(sg(ray.o), sg(ray.d)), active, sg(t_max)),
        *jax.tree.map(sg, (prep.tri, prep.cb, prep.sb)), any_hit=True)
    out = occ[:n] > 0
    return out if active is None else out & active
