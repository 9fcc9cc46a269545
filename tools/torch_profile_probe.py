"""Counts the profiler sessions that lose the calls they time: the blur
(`csrc/image.cu` `gaussian_blur`) and the library blur (replicate pad and
two depthwise `conv2d`) at the raster frame's seven shapes, each timed as
`chip_smoke.py`'s `device_ms` times it (50 calls, a separator kernel on
either side of each: a 2 x L2 write for a cold L2, a one-float add for a
warm one), 3 rounds, first with no pause on the host inside the session,
then with 50 ms before and after its work, then both again.  A session
that sees fewer than half its calls whole is printed with the kernels it
saw, and the counts per mode after each mode's rounds.

    python3 tools/torch_profile_probe.py
"""
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from d3d12renderer_tpu_torch import cuda_build  # noqa: E402
from d3d12renderer_tpu_torch.ops import image  # noqa: E402

REPS, ROUNDS, PADS = 50, 3, (0.0, 0.05, 0.0, 0.05)
SHAPES = (((540, 960, 1), 1.5), ((1080, 1920, 3), 1.5), ((540, 960, 3), 1.5),
          ((270, 480, 3), 1.5), ((135, 240, 3), 1.5), ((68, 120, 3), 1.5),
          ((1080, 1920, 3), 1.0))


def main():
    t0 = time.perf_counter()
    cuda_build.build_library()
    cuda_build.load_library()
    print("build", time.perf_counter() - t0, torch.__version__,
          torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    l2 = torch.empty(2 * torch.cuda.get_device_properties(dev).L2_cache_size
                     // 4, device=dev)
    marker = torch.zeros(1, device=dev)
    seps = {"cold": l2.zero_, "warm": lambda: marker.add_(1.0)}
    pad = [0.0]

    def kernel_events(fn):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            if pad[0]:
                time.sleep(pad[0])
            fn()
            sync()
            if pad[0]:
                time.sleep(pad[0])
        return sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    sep_names = {k: {e.name for e in kernel_events(
        lambda: [v() for _ in range(200)])} for k, v in seps.items()}
    print("separators", {k: sorted(v) for k, v in sep_names.items()},
          flush=True)
    fails, sessions = {}, {}

    def session(fn, kind, tag):
        sep = seps[kind]

        def run():
            for _ in range(REPS):
                sep()
                fn()
            sep()

        evs = kernel_events(run)
        calls, cur = [], None
        for e in evs:
            if e.name in sep_names[kind]:
                if cur:
                    calls.append(cur)
                cur = []
            elif cur is not None:
                cur.append(e.time_range.elapsed_us())
        sizes = [len(c) for c in calls]
        whole = [c for c in calls
                 if sizes and len(c) == max(set(sizes), key=sizes.count)]
        key = str((pad[0], kind))
        sessions[key] = sessions.get(key, 0) + 1
        if len(whole) < REPS // 2:
            fails[key] = fails.get(key, 0) + 1
            names = {}
            for e in evs:
                names[e.name[:60]] = names.get(e.name[:60], 0) + 1
            print("lost", json.dumps(dict(
                pad=pad[0], kind=kind, tag=tag, whole=len(whole),
                n_events=len(evs), names=names)), flush=True)

    gen = torch.Generator(device=dev).manual_seed(12)
    for p in PADS:
        pad[0] = p
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            for shape, sigma in SHAPES:
                x = torch.rand(shape, generator=gen, device=dev) * 4
                taps = image.gaussian_kernel(sigma)
                r, c = taps.shape[0] // 2, shape[2]
                x4 = x.permute(2, 0, 1)[None].contiguous()
                wv = taps.to(dev).reshape(1, 1, -1, 1).expand(
                    c, 1, -1, 1).contiguous()
                wh = taps.to(dev).reshape(1, 1, 1, -1).expand(
                    c, 1, 1, -1).contiguous()

                def library():
                    y = F.pad(x4, (r, r, r, r), mode="replicate")
                    return F.conv2d(F.conv2d(y, wv, groups=c), wh, groups=c)

                def blur():
                    return image.gaussian_blur(x, taps)

                for fn, tag in ((blur, "blur"), (library, "library")):
                    fn()
                    sync()
                    for kind in ("cold", "warm"):
                        session(fn, kind, f"{tag}{shape}")
        print("pause", p, "s", round(time.perf_counter() - t0, 1),
              "sessions", sessions, "lost", fails, flush=True)


if __name__ == "__main__":
    main()
