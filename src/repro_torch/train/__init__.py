"""Step functions of the port (the serving half so far; training is
ROADMAP Queue 1 item 9)."""
