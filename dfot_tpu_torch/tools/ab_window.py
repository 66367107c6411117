"""K600 @DiT/XL's 50-step window (four in a row, the first one cold) and the
packed attention route's host time a call, on the checkout given as the
first argument, with that checkout's own kernels and ``chip_smoke.py``
helpers. Compare two versions in one call on the card, in turns:

    for t in parent change change parent; do
        python3 dfot_tpu_torch/tools/ab_window.py build/$t $t
    done

Each run prints one JSON line: the tag, the windows' seconds, the host
microseconds of one ``attention_from_packed_qkv`` call at XL's shape.
"""
import json
import sys
import time

if __name__ == "__main__":
    tree, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from dfot_tpu_torch.ops import _cuda
    from dfot_tpu_torch.ops import qkv_prep as Q
    from dfot_tpu_torch.algorithms.dfot_video import k600_dit_xl
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.sampling import DFoTRollout, RolloutConfig

    _cuda.library()
    r = k600_dit_xl()
    T = r.max_tokens
    model = cs.sampling_copy(r, cs.build_random_model(r, seed=20, token_io=False))
    ro = DFoTRollout(RolloutConfig(max_tokens=T, x_shape=(*r.resolution, r.x_channels)), r.dcfg,
                     make_schedule(r.dcfg, "cuda"), model)
    walls = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.run_xl_window(ro, r, 8, seed=24)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    qkv = torch.randn(8, 1280, 3 * 1152, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        host = cs.host_us(lambda: Q.attention_from_packed_qkv(qkv, 16, 72))
    print(json.dumps({"tree": tag, "xl_window_s": walls, "packed_route_host_us": host}))
