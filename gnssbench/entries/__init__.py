"""The entries a traffic file can name, one file each (gnssbench/workload.py
says what an entry is)."""
