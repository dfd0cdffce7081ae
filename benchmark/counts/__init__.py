"""The benchmark's yardstick: model FLOP, kernel operations and bytes, and
the card's peaks, frozen here so that a change to the program cannot move
them."""
