"""The kinds of configuration the harness serves, one module each, loaded
by the name a configuration's file gives under ``kind``."""
