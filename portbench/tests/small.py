"""Small sizes of the cells for rehearsals on the CPU: the configurations
and traffic mixes of ``BENCHMARK.json`` with fewer clouds and points, so
that a whole run of the plain path takes seconds."""

from portbench.spec import Spec

SIZES = {"pointnet2_semseg": dict(batch=2, num_point=1024),
         "pointnet2_cls_msg": dict(batch=4, num_point=512)}


def cell(spec: Spec, name: str):
    """``(config, traffic)`` of cell ``name``, cut to the CPU."""
    c = spec.cell(name)
    cfg = spec.config(c["config"])
    cfg = dict(cfg, **SIZES[cfg["model"]])
    cfg["data"] = dict(cfg["data"], pool=8 * cfg["batch"] * c["chips"])
    mix = dict(spec.traffic(c["traffic"]), warmup=1)
    if mix["loop"] == "serve":
        mix.update(requests=4, sample=2, trace_calls=2)
    else:
        mix.update(trace_steps=2)
    return cfg, mix
