"""D4: the traceback round's banded fill with trace planes and its walk
(``tb_launch``), and the compaction of the walks' ops (``tb_compact``,
timed with it, no work of its own counted)."""
import roofline


def fill_info(a, kw, out):
    return dict(jobs=a[3], stats=a[10], n_t=a[2].numel(), n_q=a[0].numel())


def compact_info(a, kw, out):
    return None


WRAP = [("diamond_tpu_torch.ops.traceback_device", "tb_launch", fill_info),
        ("diamond_tpu_torch.ops.traceback_device", "tb_compact",
         compact_info)]


def work(info):
    return roofline.d4_work(info["jobs"].cpu().numpy(),
                            info["stats"][:, 10].cpu().numpy(), info["n_t"],
                            info["n_q"])
