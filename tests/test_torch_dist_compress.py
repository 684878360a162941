"""``compressed_psum`` (``repro_torch.distributed.compress``) over four
gloo ranks on the CPU: with the same input on every rank it is bit-equal
to the reference's over the 4-way "data" axis of a (4, 2) mesh (run in a
subprocess with 8 host devices: ``XLA_FLAGS`` stays out of this process);
with a different input per rank it equals a NumPy model of the shared
scale and the integer sum, bit for bit."""

import os
import subprocess
import sys
import textwrap

import numpy as np

from _torch_dist import psum_rank, run_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def reference_psum(x: np.ndarray, tmp_path) -> np.ndarray:
    np.save(tmp_path / "x.npy", x)
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import sys; sys.path.insert(0, {SRC!r})
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.compress import compressed_psum
        x = jnp.asarray(np.load({str(tmp_path / "x.npy")!r}))
        mesh = jax.make_mesh((4, 2), ("data", "model"))
        np.save({str(tmp_path / "want.npy")!r}, np.asarray(compressed_psum(x, mesh, "data")))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return np.load(tmp_path / "want.npy")


def numpy_psum(xs: list) -> np.ndarray:
    """The shared scale (max of the ranks' f32 scales), the codes against
    it, their int32 sum, times the scale in f32."""
    f32 = np.float32
    scales = [max(np.abs(x).max(), f32(1e-12)) / f32(127.0) for x in xs]
    g = f32(max(scales))
    codes = [np.clip(np.rint(x / g), -127, 127).astype(np.int8) for x in xs]
    summed = np.sum([c.astype(np.int32) for c in codes], axis=0, dtype=np.int32)
    return (summed.astype(f32) * g).astype(f32)


def test_same_input_bit_equal_to_reference(tmp_path):
    x = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    got = run_ranks(psum_rank, 4, tmp_path, (4, 1), [x] * 4)
    want = reference_psum(x, tmp_path)
    for g in got:
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32))
    rel = np.abs(want - 4 * x).max() / np.abs(4 * x).max()
    assert rel < 0.02  # the reference's own bound on the codec's error


def test_different_inputs_equal_integer_sum_model(tmp_path):
    rng = np.random.default_rng(1)
    xs = [(rng.normal(size=(32, 8)) * s).astype(np.float32) for s in (1, 3, 0.5, 10)]
    got = run_ranks(psum_rank, 4, tmp_path, (4, 1), xs)
    want = numpy_psum(xs)
    for g in got:
        np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32))
