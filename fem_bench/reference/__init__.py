"""Plain references of the benchmark: the glue of each mesh input
(``<kind>.glue``) and the P1 solve (``p1``). Nothing here imports the
program under test."""
