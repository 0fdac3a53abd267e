/* Strobe CLOCK_REALTIME: flip the wall clock between now and now+delta
 * every `period` ms for `duration` ms total:
 *     strobe-time <delta-ms> <period-ms> <duration-ms>
 * Equivalent role to the reference's resources/strobe-time.c (compiled
 * on-node by nemesis/time.clj); fresh implementation.
 */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include <unistd.h>

static void shift_ms(long long delta_ms) {
  struct timespec ts;
  if (clock_gettime(CLOCK_REALTIME, &ts) != 0) return;
  long long ns = ts.tv_nsec + (delta_ms % 1000) * 1000000LL;
  ts.tv_sec += delta_ms / 1000 + ns / 1000000000LL;
  ts.tv_nsec = ns % 1000000000LL;
  if (ts.tv_nsec < 0) {
    ts.tv_nsec += 1000000000L;
    ts.tv_sec -= 1;
  }
  clock_settime(CLOCK_REALTIME, &ts);
}

int main(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s <delta-ms> <period-ms> <duration-ms>\n",
            argv[0]);
    return 2;
  }
  long long delta = atoll(argv[1]);
  long long period = atoll(argv[2]);
  long long duration = atoll(argv[3]);
  if (period <= 0) period = 1;
  long long elapsed = 0;
  int forward = 1;
  while (elapsed < duration) {
    shift_ms(forward ? delta : -delta);
    forward = !forward;
    usleep((useconds_t)(period * 1000));
    elapsed += period;
  }
  if (!forward) shift_ms(-delta); /* leave the clock where we found it */
  return 0;
}
