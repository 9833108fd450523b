"""Dependency-free JSON-Schema subset validator for the obs artifacts.

CI exports a governed-serve obs snapshot (`examples/trace_a_request.py`)
and validates it against the checked-in schema `tests/schemas/obs.json`
without installing `jsonschema`. The supported keyword subset — `type`
(string or list), `properties`, `required`, `items`,
`additionalProperties` (bool or schema), `enum`, `minimum`, `maximum` —
covers everything the obs schema uses; unknown keywords are ignored, as
JSON Schema itself specifies.

CLI:  python -m repro.obs.schema <instance.json> <schema.json>
exits non-zero listing every violation.
"""
from __future__ import annotations

import json
import sys

__all__ = ["validate", "validate_file"]

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value, tname: str) -> bool:
    py = _TYPES[tname]
    if isinstance(value, bool):          # bool is an int in Python; JSON isn't
        return tname == "boolean"
    return isinstance(value, py)


def validate(instance, schema: dict, path: str = "$") -> list[str]:
    """All violations of `schema` by `instance` (empty list = valid)."""
    errors: list[str] = []
    t = schema.get("type")
    if t is not None:
        names = t if isinstance(t, list) else [t]
        if not any(_type_ok(instance, n) for n in names):
            errors.append(f"{path}: expected type {t}, "
                          f"got {type(instance).__name__}")
            return errors           # deeper keywords assume the right type
    if "enum" in schema and instance not in schema["enum"]:
        errors.append(f"{path}: {instance!r} not in enum {schema['enum']}")
    if isinstance(instance, (int, float)) and not isinstance(instance, bool):
        if "minimum" in schema and instance < schema["minimum"]:
            errors.append(f"{path}: {instance} < minimum {schema['minimum']}")
        if "maximum" in schema and instance > schema["maximum"]:
            errors.append(f"{path}: {instance} > maximum {schema['maximum']}")
    if isinstance(instance, dict):
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in instance:
                errors.append(f"{path}: missing required key {req!r}")
        for k, v in instance.items():
            if k in props:
                errors += validate(v, props[k], f"{path}.{k}")
            else:
                ap = schema.get("additionalProperties", True)
                if ap is False:
                    errors.append(f"{path}: unexpected key {k!r}")
                elif isinstance(ap, dict):
                    errors += validate(v, ap, f"{path}.{k}")
    if isinstance(instance, list) and "items" in schema:
        for i, v in enumerate(instance):
            errors += validate(v, schema["items"], f"{path}[{i}]")
    return errors


def validate_file(instance_path: str, schema_path: str) -> list[str]:
    with open(instance_path) as f:
        instance = json.load(f)
    with open(schema_path) as f:
        schema = json.load(f)
    return validate(instance, schema)


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: python -m repro.obs.schema <instance.json> "
              "<schema.json>", file=sys.stderr)
        return 2
    errors = validate_file(argv[0], argv[1])
    if errors:
        for e in errors:
            print(f"schema violation: {e}", file=sys.stderr)
        return 1
    print(f"{argv[0]}: valid against {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
