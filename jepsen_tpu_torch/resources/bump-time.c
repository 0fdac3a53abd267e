/* Adjust CLOCK_REALTIME by a signed millisecond delta: `bump-time 500`
 * jumps the wall clock half a second forward, `bump-time -500` back.
 * The delta MUST be argv[1]: there is no option parsing, and a "--"
 * separator would be atoll'd to 0 — a silent no-op bump.
 * Compiled on the DB node by the clock nemesis, the same strategy the
 * reference uses (jepsen/src/jepsen/nemesis/time.clj:21-40 compiles
 * resources/bump-time.c with gcc at setup time).  Fresh implementation.
 */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <delta-ms>\n", argv[0]);
    return 2;
  }
  long long delta_ms = atoll(argv[1]);
  struct timespec ts;
  if (clock_gettime(CLOCK_REALTIME, &ts) != 0) {
    perror("clock_gettime");
    return 1;
  }
  long long ns = ts.tv_nsec + (delta_ms % 1000) * 1000000LL;
  ts.tv_sec += delta_ms / 1000 + ns / 1000000000LL;
  ts.tv_nsec = ns % 1000000000LL;
  if (ts.tv_nsec < 0) {
    ts.tv_nsec += 1000000000L;
    ts.tv_sec -= 1;
  }
  if (clock_settime(CLOCK_REALTIME, &ts) != 0) {
    perror("clock_settime");
    return 1;
  }
  return 0;
}
