"""K2: the full-matrix affine-gap sweep of ``--swipe`` (``full_swipe``),
its work from the launch's pairs, queries and targets."""
import roofline


def info(a, kw, out):
    return dict(targets=a[1], reqs=a[4], pairs=a[5], n_t=a[0].numel(),
                n_q=a[2].numel())


WRAP = [("diamond_tpu_torch.ops.swipe_device", "full_swipe", info)]


def work(info):
    return roofline.k2_work(info["pairs"].cpu().numpy(),
                            info["reqs"].cpu().numpy(),
                            info["targets"].cpu().numpy(), info["n_t"],
                            info["n_q"])
