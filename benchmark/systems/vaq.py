"""``vaq``: a ``vaq_tpu_torch.VAQIndex`` of the configuration's ``method``,
trained on the training rows, encoded ``encode_chunk_rows`` rows at a time
and, where the configuration has a ``probe``, given the cluster probe
(``attach_ivf``), as a user of the port's public API builds it; judged by
``harness/check.py`` against the plain reference (``reference/``)."""

from benchmark.harness import check, variants


def build(cell, base, train_ids, device, variant=None):
    import vaq_tpu_torch
    cfg = cell.config
    idx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string(cfg["method"]), device=device)
    train = base if train_ids is None else base[train_ids]
    idx.train(train.cpu().numpy())
    variants.after_train(idx, variant, train)
    del train
    chunk = int(cfg["encode_chunk_rows"])
    idx.encode_chunks(lambda i: base[i * chunk:(i + 1) * chunk],
                      base.shape[0], chunk)
    probe = cfg.get("probe")
    if probe:
        with variants.building_probe(variant):
            vaq_tpu_torch.attach_ivf(idx,
                                     ti_segment_num=int(probe["segments"]),
                                     visit=float(probe["visit"]))
    return idx


def state(idx) -> dict:
    return check.program_state(idx)


def numbers(st, answers, base, queries, train_ids, seed, k, cfg,
            control=None):
    return check.numbers(st, answers, base, queries, train_ids, seed, k,
                         probe=cfg.get("probe"), control=control)
