"""The frozen plain tracking scan and its set-up (reference/__init__.py
names the origins)."""
