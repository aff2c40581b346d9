"""K1: the banded score-only DP of a DeviceDP batch
(``DeviceDP.launch``), its work from the batch's jobs and letters."""
import roofline


def info(a, kw, out):
    p = a[1]
    return dict(jobs=p.jobs, reqs=p.reqs, n_t=p.t_cat.numel(),
                n_q=p.q_cat.numel())


WRAP = [("diamond_tpu_torch.ops.swipe_device", "DeviceDP.launch", info)]


def work(info):
    return roofline.k1_work(info["jobs"].cpu().numpy(),
                            info["reqs"].cpu().numpy(), info["n_t"],
                            info["n_q"])
