"""Polymorphic JSON/YAML (de)serialization with ``__class__`` tags."""
