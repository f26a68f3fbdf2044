"""Host milliseconds a train step spends in the modality pre-nets (the
program's spans ``train/mm.pre_<i>``, every pre-net and both branches,
over the count of ``train/step``)."""


def read(data: dict):
    s = (data.get("spans") or {}).get("spans", {})
    pre = [v["total_s"] for k, v in s.items()
           if k.startswith("train/mm.pre_")]
    n = s.get("train/step", {}).get("count")
    return 1e3 * sum(pre) / n if pre and n else None
