"""Lock-discipline annotations (the static checker itself is not ported)."""
