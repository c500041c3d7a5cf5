"""markers.k5_roofline: K5 ``sort_pairs`` (``ops/csrc/sort.cu``), the
largest device kernel of stage 00, against its bound, in percent: the
frozen bound of ``roofline.py`` for every sort the window made (each key
and payload read and written once, SORT_PASS_OPS a key a pass) over the
device time of K5's kernels (its histogram, plan and pass kernels; its
one zero fill a call is not among them).  The sorts are counted by a
wrapper the benchmark puts around ``kmer_count.sort_pairs`` for the
traced window; nothing is read unless the trace holds every kernel those
sorts launched (a histogram, a plan and one pass kernel a pass and
portion of 2^27 keys)."""

from portbench import roofline

PORTION = 1 << 27
PREFIX = "onesweep_"


def arm(run) -> None:
    from hast_tpu_torch.ops import kmer_count as KC
    real = KC.sort_pairs
    calls = []

    def counted(keys, payload, k, *args, **kwargs):
        if keys.is_cuda and keys.numel():
            calls.append((keys.numel(), payload is not None, k))
        return real(keys, payload, k, *args, **kwargs)

    KC.sort_pairs = counted
    run.store["k5"] = (real, calls)


def measure(run) -> None:
    from hast_tpu_torch.ops import kmer_count as KC
    KC.sort_pairs = run.store["k5"][0]


def read(run):
    calls = run.store["k5"][1]
    want = sum(2 + roofline.sort_passes(k) * -(-n // PORTION)
               for n, _, k in calls)
    recs = [d for n, _, d in run.summary["device"] if PREFIX in n]
    if not calls or len(recs) != want:
        return None
    bound = sum(roofline.k5_bound_ms(n, k, pay) for n, pay, k in calls)
    return 100.0 * bound / (sum(recs) / 1e3)
