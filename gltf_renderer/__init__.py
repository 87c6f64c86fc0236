"""gltf_renderer — a JAX/XLA glTF 2.0 rendering framework (GPU kernels in Pallas).

Capability parity target: l-johnson-code/glTF-Renderer (DX12 forward rasterizer +
DXR 1.1 progressive path tracer, glTF 2.0 + KHR material extensions, HDR
environment IBL, skinning/morph animation, bloom, AgX tone mapping).

Everything on the compute path is pure jitted JAX: the scene is a pytree of
arrays, a frame is one `jax.jit`-ed function, and multi-chip scaling is
`shard_map` over the pixel/sample grid.
"""

__version__ = "0.1.0"
