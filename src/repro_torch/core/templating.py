"""Manifest templating (the port's copy of ``repro.core.templating``).

The paper auto-generates its 288 Kubernetes YAML files and per-experiment
JSON configs with Jinja2; this is a dependency-free equivalent: ``{{ var
}}`` substitution (with dotted lookups) over strings and nested
structures, plus a minimal YAML emitter so manifests land on disk in the
same form the paper's automation submits.  A manifest's container command
names the port's training module, ``repro_torch.launch.train``; the rest
of a manifest is byte for byte the reference's."""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

_VAR = re.compile(r"\{\{\s*([\w.\[\]]+)\s*\}\}")


def _lookup(ctx: Mapping, dotted: str):
    cur: Any = ctx
    for part in dotted.split("."):
        m = re.match(r"(\w+)\[(\d+)\]$", part)
        if m:
            cur = cur[m.group(1)][int(m.group(2))]
        elif isinstance(cur, Mapping):
            cur = cur[part]
        else:
            cur = getattr(cur, part)
    return cur


def render_template(template, ctx: Mapping):
    """Recursively render {{ var }} placeholders in strings / dict / list
    structures.  A string that is exactly one placeholder keeps the looked-up
    value's type (so resource numbers stay numbers)."""
    if isinstance(template, str):
        whole = _VAR.fullmatch(template.strip())
        if whole:
            return _lookup(ctx, whole.group(1))
        return _VAR.sub(lambda m: str(_lookup(ctx, m.group(1))), template)
    if isinstance(template, Mapping):
        return {k: render_template(v, ctx) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [render_template(v, ctx) for v in template]
    return template


JOB_TEMPLATE = {
    "apiVersion": "batch/v1",
    "kind": "Job",
    "metadata": {
        "name": "{{ name }}",
        "labels": {"experiment": "{{ experiment }}", "app": "repro"},
    },
    "spec": {
        "backoffLimit": "{{ retries }}",
        "template": {"spec": {
            "containers": [{
                "name": "{{ name }}",
                "image": "{{ image }}",
                "command": ["python", "-m", "{{ module }}"],
                "env": "{{ env_list }}",
                "resources": {"limits": {
                    "nvidia.com/gpu": "{{ gpus }}",
                    "cpu": "{{ cpus }}",
                    "memory": "{{ memory }}",
                }},
                "volumeMounts": [{"name": "data", "mountPath": "/data"}],
            }],
            "volumes": [{"name": "data",
                         "persistentVolumeClaim": {"claimName": "{{ pvc }}"}}],
            "restartPolicy": "Never",
        }},
    },
}


def render_job_manifest(name: str, *, experiment: str = "default",
                        module: str = "repro_torch.launch.train",
                        image: str = "repro/trainer:latest",
                        env: Dict[str, str] = None,
                        gpus: int = 1, cpus: int = 4, memory_gb: float = 24,
                        retries: int = 3, pvc: str = "repro-data") -> dict:
    env = env or {}
    ctx = {
        "name": name, "experiment": experiment, "module": module,
        "image": image, "retries": retries, "gpus": gpus, "cpus": cpus,
        "memory": f"{memory_gb:g}Gi", "pvc": pvc,
        "env_list": [{"name": k, "value": str(v)}
                     for k, v in sorted(env.items())],
    }
    return render_template(JOB_TEMPLATE, ctx)


def to_yaml(obj, indent: int = 0) -> str:
    """Tiny YAML emitter (subset: dicts, lists, scalars)."""
    pad = "  " * indent
    if isinstance(obj, Mapping):
        if not obj:
            return pad + "{}"
        lines = []
        for k, v in obj.items():
            if isinstance(v, (Mapping, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(to_yaml(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")
        return "\n".join(lines)
    if isinstance(obj, list):
        if not obj:
            return pad + "[]"
        lines = []
        for v in obj:
            if isinstance(v, (Mapping, list)) and v:
                body = to_yaml(v, indent + 1)
                first, _, rest = body.partition("\n")
                lines.append(f"{pad}- {first.strip()}" + ("\n" + rest if rest else ""))
            else:
                lines.append(f"{pad}- {_scalar(v)}")
        return "\n".join(lines)
    return pad + _scalar(obj)


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return f"{v:g}" if isinstance(v, float) else str(v)
    s = str(v)
    if re.search(r"[:#{}\[\],&*?|>'\"%@`]", s) or s != s.strip():
        return '"' + s.replace('"', '\\"') + '"'
    return s
