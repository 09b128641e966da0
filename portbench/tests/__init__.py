"""CPU tests of the benchmark (tiny sizes); card tests carry the ``gpu`` marker."""
