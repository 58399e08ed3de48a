"""Public user-facing API (reference: the exported R surface, SURVEY.md §3.1)."""
