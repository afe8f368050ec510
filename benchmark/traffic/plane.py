"""Camera streams over a textured plane, rendered on the device from a seed.

Frozen copy, rewritten in PyTorch so that it renders on the card in a few
large calls, of:

* ``mqslam_tpu_torch/frontend/synthetic.py:22-95`` (``make_texture``,
  ``_bilinear_wrap``, ``render_plane_sequence``, ``backproject_to_plane``):
  a smooth random texture on the plane z = ``plane_z``, each pixel's ray
  cut with the plane and the texture sampled bilinearly with wrap-around;
* ``mqslam_tpu_torch/cli/loop_demo.py:28-50`` (``circuit_trajectory``): a
  closed rectangular circuit (+x, +y, -x, -y, its sides 1 : 0.7) at a fixed
  height, the camera looking along +z at the plane.

What differs from the sources: the texture's noise comes from a
``torch.Generator`` instead of NumPy's, every agent gets its own texture,
its own offset of the circuit on the plane and its own start along it, each
circuit is sized so that the agent flies it in one lap at its own speed
(the traffic's ``speeds_m_s``, agent a taking entry a modulo their number),
the camera has its own principal point and focal lengths, and frames carry
Gaussian sensor noise and are rounded to 8 bits, as a camera delivers
them.  Agent a starts at frame a * lap / A of its circuit (the same for
every seed); the seed draws the textures, the offsets and the noise.  The
program never sees this module: it gets the frames.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_textures", "circuit_centres", "circuit_side", "render",
           "backproject", "stream"]

ASPECT = 0.7          # the circuit's second side over its first


def make_textures(gen, n, size=1024, blur_passes=2, device="cpu"):
    """[n, size, size] float32 textures (0..255): uniform noise on a 4x4
    block grid, blurred ``blur_passes`` times by the 5x5 binomial kernel
    with wrap-around."""
    tex = torch.rand((n, 1, size // 4, size // 4), generator=gen,
                     device=device, dtype=torch.float32) * 255.0
    tex = tex.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=device)
    k = (k[:, None] * k[None, :]) / 256.0
    for _ in range(blur_passes):
        tex = F.conv2d(F.pad(tex, (2, 2, 2, 2), mode="circular"),
                       k[None, None])
    return tex[:, 0]


def circuit_centres(lap_frames, side=4.2, height=0.0):
    """[lap_frames, 3] camera centres of the closed circuit, frame 0 at the
    first corner (float64, host)."""
    legs = 4
    per = lap_frames // legs
    way = np.array([[0.0, 0.0, height], [side, 0.0, height],
                    [side, side * ASPECT, height],
                    [0.0, side * ASPECT, height],
                    [0.0, 0.0, height]])
    out = np.zeros((lap_frames, 3))
    for i in range(lap_frames):
        leg = min(i // per, legs - 1)
        frac = (i - leg * per) / per
        out[i] = way[leg] * (1 - frac) + way[leg + 1] * frac
    return out


def circuit_side(speed, lap_frames, fps):
    """The first side (m) of the circuit flown in ``lap_frames`` frames at
    ``fps`` frames/s and ``speed`` m/s."""
    return speed * lap_frames / fps / (2.0 * (1.0 + ASPECT))


def _sample_wrap(tex, x, y):
    """Bilinear samples of tex [S, S] at x, y (any shape), wrapping."""
    S = tex.shape[-1]
    x = torch.remainder(x, S)
    y = torch.remainder(y, S)
    x0 = torch.clamp(torch.floor(x), max=S - 1)
    y0 = torch.clamp(torch.floor(y), max=S - 1)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1) % S, (y0 + 1) % S
    flat = tex.reshape(-1)
    g = lambda yy, xx: flat[yy * S + xx]
    return ((1 - fy) * ((1 - fx) * g(y0, x0) + fx * g(y0, x1))
            + fy * ((1 - fx) * g(y1, x0) + fx * g(y1, x1)))


def render(textures, centres, camera, plane_z, tex_scale, noise_sigma, gen,
           chunk=8):
    """Frames [A, N, H, W] uint8 on the host of cameras at ``centres``
    [A, N, 3] (world), axes aligned with the world's, looking along +z at
    the plane, with the pinhole ``camera`` (``width``, ``height``, ``fx``,
    ``fy``, ``cx``, ``cy``); agent a sees ``textures[a]``.  Rendered ``chunk`` frames at
    a time on the textures' device, Gaussian noise of ``noise_sigma``
    gray levels added, rounded and clipped to 0..255."""
    dev = textures.device
    A, N = centres.shape[:2]
    W, H = int(camera["width"]), int(camera["height"])
    xn = (torch.arange(W, device=dev, dtype=torch.float32)
          - float(camera["cx"])) / float(camera["fx"])
    yn = (torch.arange(H, device=dev, dtype=torch.float32)
          - float(camera["cy"])) / float(camera["fy"])
    c = torch.as_tensor(centres, dtype=torch.float32, device=dev)
    out = torch.empty((A, N, H, W), dtype=torch.uint8)
    for a in range(A):
        for n0 in range(0, N, chunk):
            cc = c[a, n0:n0 + chunk]                       # [n, 3]
            s = (plane_z - cc[:, 2])[:, None, None]
            wx = cc[:, 0, None, None] + s * xn[None, None, :]
            wy = cc[:, 1, None, None] + s * yn[None, :, None]
            wx, wy = torch.broadcast_tensors(wx, wy)
            img = _sample_wrap(textures[a], wx * tex_scale, wy * tex_scale)
            if noise_sigma > 0:
                img = img + noise_sigma * torch.randn(
                    img.shape, generator=gen, device=dev)
            out[a, n0:n0 + chunk] = torch.clamp(
                torch.round(img), 0, 255).to(torch.uint8).cpu()
    return out


def backproject(uv, centre, camera, plane_z):
    """[n, 3] world points of pixels uv [n, 2] (NumPy) of the pinhole
    ``camera`` at ``centre`` (axes aligned with the world's) on the plane
    z = plane_z."""
    uv = np.asarray(uv, np.float64)
    d = np.stack([(uv[:, 0] - camera["cx"]) / camera["fx"],
                  (uv[:, 1] - camera["cy"]) / camera["fy"],
                  np.ones(len(uv))], axis=1)
    s = (plane_z - centre[2]) / d[:, 2]
    return centre[None, :] + s[:, None] * d


def stream(params, camera, seed, agents, device):
    """The frames of ``agents`` flights over one lap each, from the
    traffic ``params`` (``lap_frames``, ``speeds_m_s``, ``plane_z``,
    ``tex_scale``, ``noise_sigma``, ``offset_m``: the largest offset of a
    circuit on the plane) and the camera (``width``, ``height``, ``fx``,
    ``fy``, ``cx``, ``cy``, ``fps``).  Returns (frames [A, lap + 1, H, W]
    uint8 host, centres [A, lap + 1, 3] float64): frame ``lap`` closes the
    circuit where frame 0 began.  The same seed gives the same frames."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    rng = np.random.RandomState(int(seed) % (2 ** 32))
    lap = int(params["lap_frames"])
    speeds = params["speeds_m_s"]
    # starts spread evenly along the lap, whatever the seed: every seed
    # gives the same mix of straight legs and corners a frame-group
    starts = np.arange(agents) * lap // agents
    offsets = rng.uniform(0.0, params["offset_m"], size=(agents, 2))
    centres = np.zeros((agents, lap + 1, 3))
    for a in range(agents):
        side = circuit_side(float(speeds[a % len(speeds)]), lap,
                            float(camera["fps"]))
        idx = (starts[a] + np.arange(lap + 1)) % lap
        centres[a] = circuit_centres(lap, side, 0.0)[idx]
        centres[a, :, :2] += offsets[a]
    tex = make_textures(gen, agents, device=device)
    frames = render(tex, centres, camera, float(params["plane_z"]),
                    float(params["tex_scale"]), float(params["noise_sigma"]),
                    gen)
    return frames, centres

