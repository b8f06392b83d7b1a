"""Film grain's share of its byte roofline: the least time the grain of
the profiled frames can take (their byte floor over the H100's HBM rate,
`readers.HBM_BYTES_PER_S`) over the device time of `fg_frame_kernel`.

The floor of a shown frame, whatever the kernel's design, over the
planes its header grains (the frame table's "grain", written by
`grain_facts.py`), at the stream's sample size (1 byte at 8 bits, 2
above): each such plane read once and written once, and luma read once
where a chroma plane takes grain and luma does not (chroma scales by
luma).  Templates and LUTs are left out.  A 1080p 8-bit 4:2:0 frame
with all three planes grained: 2 x (2,073,600 + 2 x 518,400) =
6,220,800 bytes, 1.857 us at 3.35 TB/s.  None where the kernel did not
run (a program without it) or no profiled frame takes grain.
"""

import readers

KERNEL = "fg_frame_kernel"


def grain_bytes(cfg, frame) -> int:
    """The least bytes the film grain of one shown frame moves."""
    planes = frame.get("grain", [])
    n = readers.plane_samples(cfg)
    total = 2 * sum(n[p] for p in planes)
    if planes and 0 not in planes:
        total += n[0]
    return (1 if cfg["bit_depth"] == 8 else 2) * total


def read(run, spec):
    p = run.profile
    if p is None:
        return None
    t = readers.kernel_ns(p, [KERNEL])
    need = sum(grain_bytes(run.config, run.config["frames"][i])
               for i in p["frame_indices"])
    if t <= 0 or need <= 0:
        return None
    return 100.0 * (need / readers.HBM_BYTES_PER_S) / (t * 1e-9)
