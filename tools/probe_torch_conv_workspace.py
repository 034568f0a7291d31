"""Device memory and time of the VGG16 3x3 convs of a 1/2 width shard at
32x128 b32 f32 (the width-sharded GAN step's perceptual loss), forward and
input gradient (the VGG weights are frozen), by formulation, on one card:

  halo      the shard with its one-column halos, padding 1, the two extra
            output columns dropped (one cuDNN call for the whole batch);
  chunks8   the same in chunks of 8 samples (`models/vgg16.py`'s
            WIDTH_CONV_BATCH);
  embed     the extended shard zero-padded to the whole width;
  native    the halo form with cuDNN off (PyTorch's own conv);
  whole     the whole panorama's conv, for scale.

Each entry is [MiB, ms]: `max_memory_allocated` above `memory_allocated`
before the call (the outputs and gradients included), and the CUDA-event
median of 5 calls after a warm-up. Prints one JSON object.

    python tools/probe_torch_conv_workspace.py
"""

import json
import statistics

import torch
import torch.nn.functional as F

SHAPES = ((64, 64, 32, 64), (128, 128, 16, 32), (256, 256, 8, 16))  # c, f, h, w of a shard


def measure(fn):
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return [round(mib, 1), round(statistics.median(times), 3)]


def main():
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for c, f, h, w in SHAPES:
        wt = torch.randn(f, c, 3, 3, device="cuda")
        xe = torch.randn(32, c, h, w + 2, device="cuda", requires_grad=True)
        xw = torch.randn(32, c, h, 2 * w, device="cuda", requires_grad=True)
        g = torch.randn(32, f, h, w, device="cuda")
        gw = torch.randn(32, f, h, 2 * w, device="cuda")

        def halo():
            F.conv2d(xe, wt, padding=1)[..., 1:-1].backward(g)

        def chunks8():
            torch.cat([F.conv2d(t, wt, padding=1)[..., 1:-1] for t in xe.split(8)]).backward(g)

        def embed():
            F.conv2d(F.pad(xe, (0, w - 2)), wt, padding=1)[..., 1:w + 1].backward(g)

        def native():
            with torch.backends.cudnn.flags(enabled=False):
                F.conv2d(xe, wt, padding=1)[..., 1:-1].backward(g)

        def whole():
            F.conv2d(xw, wt, padding=1).backward(gw)

        out[f"{c}->{f} {h}x{w}"] = {fn.__name__: measure(fn)
                                    for fn in (halo, chunks8, embed, native, whole)}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shapes": out}))


if __name__ == "__main__":
    main()
