"""setup_s: Set-up: process start to the window's start (host clock)."""

def read(rec):
    return rec["setup_s"]
