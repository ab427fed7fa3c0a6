"""Polymorphic JSON/YAML (de)serialization with ``__class__`` tags."""
from awesome_tpu_torch.serialization.jsonconv import (  # noqa: F401
    from_jsonable,
    load_json,
    load_yaml,
    register_rule,
    save_json,
    save_yaml,
    to_jsonable,
)
