"""What the hand-written kernels size themselves against on the card.

One place for the limits that every kernel's legality and proxy problem
read, so no kernel module learns them from another.
"""

#: opt-in shared memory per block of the H100 (bytes): the staging limit
#: legality checks against when no card is asked about
H100_SMEM_OPTIN = 232_448
#: thread blocks a proxy problem launches (about two per SM of the H100's
#: 132), so a config is timed in throughput, not one block's latency
PROXY_BLOCKS = 256
